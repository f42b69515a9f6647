from .ops import rglru_scan  # noqa: F401
