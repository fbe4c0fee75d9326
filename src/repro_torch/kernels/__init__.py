"""Hand-written Hopper kernels, their plain PyTorch versions and oracles.

Importing this package builds nothing: a kernel is compiled on its first
launch (``build.py``) on a machine with ``nvcc`` and a card.
"""
