"""Oracle scorer (``serve/serve_loop.PairScorer``): tokenizing the pairs
and padding each batch, on the host between forwards: the mean per
completed query of the system's ``score_tokenize_s`` span, in ms."""
from harness.program_log import span_mean_ms

DEVICE = False


def read(ctx):
    return span_mean_ms(ctx, "score_tokenize_s")
