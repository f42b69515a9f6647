from .ops import rwkv6_scan  # noqa: F401
