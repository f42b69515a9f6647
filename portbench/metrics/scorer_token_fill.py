"""Oracle scorer (``serve/serve_loop.PairScorer``): the share of the token
positions forwarded that hold a pair's prompt, in %: the system's counters
``scorer.tokens_useful`` over ``scorer.tokens_forwarded`` (rows, padding
rows included, times each batch's padded length) in the traced window."""
from harness.program_log import share

DEVICE = False


def read(ctx):
    return share("scorer.tokens_useful", "scorer.tokens_forwarded")
