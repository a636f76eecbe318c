"""CPU tests of the benchmark (``python -m pytest --noconftest portbench/tests``
from the repository's root); the ones marked ``cuda`` run on a card."""
