"""The plain float64 reference, one module per metric class of the port,
named as the class is: ``reference(preds, target, kwargs)`` takes the
inputs the port got, as the benchmark made them (plain ``torch`` tensors,
on the card in a run, on the CPU in the tests), and returns the values the
port's ``compute()`` returns, flattened in the same order, as a float64
NumPy array. It runs once the measured window has closed and the port's
state is freed. Nothing here imports the port, JAX or the JAX package.
"""
