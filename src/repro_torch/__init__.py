"""PyTorch + CUDA port of JoinML-X: the query engine and the Oracle model
stack that serves its predicate (``repro`` is the JAX reference).  Entry points run on a CUDA card by default and raise without
one; pass ``device="cpu"`` to run the plain PyTorch versions of the kernels.

Imports neither ``jax`` nor the reference package."""
from .device import resolve_device  # noqa: F401
