from .ops import PreparedRight, SweepOut, prepare_right, sim_sweep  # noqa: F401
