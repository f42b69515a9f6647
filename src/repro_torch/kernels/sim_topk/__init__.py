from .ops import sim_topk  # noqa: F401
