"""Plain NumPy version of the bootstrap-t's resampling (see
``kernels/plain.py``)."""
from ..plain import resample_moments_plain


def resample_moments_ref(sum_terms, count_terms, n_boot, state, flags):
    """``((5, n_boot) f64 moments, the Generator's state after, rejections)``
    of :func:`repro_torch.kernels.plain.resample_moments_plain`."""
    return resample_moments_plain(sum_terms, count_terms, n_boot, state, flags)
