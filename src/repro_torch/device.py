"""Device resolution for the port.

Every entry point takes ``device=`` and defaults to ``"cuda"``: the port is
built to run on the card.  Without a card, ``"cuda"`` raises instead of
quietly running on the CPU; only callers that ask for ``device="cpu"`` (the
tests) get the plain PyTorch versions of the kernels.

The fp32 sweep must not run in TF32: both switches are set off here, once,
when the first device is resolved, and asserted on every resolution.
"""
from __future__ import annotations

import numpy as np
import torch


def _no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


_no_tf32()


def resolve_device(device="cuda") -> torch.device:
    """``"cuda"`` / ``"cpu"`` / ``"meta"`` / a :class:`torch.device` ->
    torch.device.  ``"meta"`` (asked for by name) makes tensors without
    storage, on which the dry run traces a step (``launch.dryrun``).

    Raises :class:`RuntimeError` for a CUDA device when no card is present.
    """
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on a CUDA card by default and none was "
                "found; pass device='cpu' to run the plain PyTorch versions"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type not in ("cpu", "meta"):
        raise ValueError(f"unsupported device {device!r}")
    assert not torch.backends.cuda.matmul.allow_tf32, "TF32 matmul is on"
    assert not torch.backends.cudnn.allow_tf32, "TF32 convolution is on"
    return dev


def host_f32(x) -> np.ndarray:
    """``x`` as C-contiguous, writable f32 numpy rows, the form
    ``torch.from_numpy`` takes without a warning.  A read-only array (an
    index artifact's embeddings after an mmap load) is copied once, here,
    where the rows enter the port's torch code."""
    arr = np.ascontiguousarray(x, np.float32)
    return arr if arr.flags.writeable else arr.copy()
