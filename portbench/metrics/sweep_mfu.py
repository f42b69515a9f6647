"""The whole query on the card: the sweep's operations (2 m n d a query) of
the queries completed over the window's seconds times the CUDA cores' f32
peak, in %.  It reads the same work whatever kernels do it."""
from harness.yardstick import PEAK_FLOPS_F32

DEVICE = True


def read(ctx):
    done = ctx.window.completed
    if not done or ctx.window.window_s <= 0:
        return None
    (n1, d), (n2, _) = ctx.tables.emb[0].shape, ctx.tables.emb[1].shape
    return 100.0 * 2.0 * n1 * n2 * d * len(done) / (ctx.window.window_s * PEAK_FLOPS_F32)
