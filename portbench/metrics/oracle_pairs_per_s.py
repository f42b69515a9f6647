"""Oracle scorer (``serve/serve_loop.PairScorer``): the pairs the scorer
counted in the window (``pairs_scored``) over the seconds spent inside its
``score`` calls, each of which ends in a copy to the host."""

DEVICE = False


def read(ctx):
    pairs = getattr(ctx.oracle, "window_pairs", 0)
    secs = getattr(ctx.oracle, "window_seconds", 0.0)
    return pairs / secs if pairs and secs > 0 else None
