"""Model (``models/model.py``, ``layers.py``): the useful operations of the
pairs scored in the window over the window's seconds times the card's bf16
dense peak, in %.  Useful: each pair's unpadded prompt through the decoder
(the attention projections, the router, the experts a token is sent to,
attention's products) and the LM head at the one position read; no padded
position, padding row or capacity slot (``harness/yardstick.py``)."""
from harness.yardstick import PEAK_FLOPS_BF16

DEVICE = True


def read(ctx):
    flops = getattr(ctx.oracle, "window_flops", None)
    if flops is None or ctx.window.window_s <= 0:
        return None
    total = flops()
    return 100.0 * total / (ctx.window.window_s * PEAK_FLOPS_BF16) if total > 0 else None
