from .ops import resample_moments  # noqa: F401
