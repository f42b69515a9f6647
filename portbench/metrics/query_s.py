"""End to end: the measured window's seconds over the queries completed in
it, a closed loop's time per query (host clock)."""

DEVICE = False


def read(ctx):
    done = ctx.window.completed
    return ctx.window.window_s / len(done) if done else None
