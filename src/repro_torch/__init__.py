"""PyTorch/CUDA port of the generative semantic cache (the ``repro``
package is its JAX reference). Imports torch, numpy and the stdlib only."""
