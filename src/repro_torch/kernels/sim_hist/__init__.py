from .ops import sim_hist  # noqa: F401
