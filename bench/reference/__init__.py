"""Plain PyTorch / NumPy references the benchmark holds the program against.

Nothing here imports ``jax``, the JAX package or the PyTorch port: each
module restates, from the published description and the configuration's
numbers, what the served system has to compute, in float32 (TF32 off),
from the same raw inputs the benchmark hands the program (seeded weights,
filler rows, texts).
"""
