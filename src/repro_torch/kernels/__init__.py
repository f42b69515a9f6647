"""Hand-written CUDA kernels of the port and their plain PyTorch versions.

``cuda_lib.LAUNCHES`` counts every kernel launch by kernel name."""
from .cuda_lib import LAUNCHES, reset_launches  # noqa: F401
