"""Seeded input generators, one module per configuration ``generator``.

Each module has ``make(config, seed, device)`` returning one epoch's
``(preds, target)`` on ``device``, drawn by a ``torch.Generator`` on that
device in a few large calls: the same seed gives the same tensors.
"""
