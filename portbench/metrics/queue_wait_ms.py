"""Serving plane (``serve/oracle_service.py``): the time a query's flushes
wait in the service's queue for their window's dispatch: the mean per
completed query of the system's ``queue_wait_s`` span (every flush's wait,
summed), in ms."""
from harness.program_log import span_mean_ms

DEVICE = False


def read(ctx):
    return span_mean_ms(ctx, "queue_wait_s")
