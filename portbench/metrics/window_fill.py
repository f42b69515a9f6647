"""Serving plane (``serve/oracle_service.py``): the share of the service's
window slots that flushes' rows filled, in %: the service's own
``window_fill_ratio`` (rows entering windows over windows x ``max_batch``,
from ``OracleService.stats()``) at the window's end.  It counts the
set-up's one warm query's windows too.  None without a service."""

DEVICE = False


def read(ctx):
    stats = ctx.service
    if not stats or "window_fill_ratio" not in stats:
        return None
    return 100.0 * float(stats["window_fill_ratio"])
