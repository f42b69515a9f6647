"""What the program recorded itself, for the readers of its spans and
counters: a query's ``timings`` (one key a span name, summed) and the
counters of ``repro_torch.obs.telemetry.window_log()``, which the program
fills while a profiler session records, so in a traced window only.  A
program without the log, or without a span, gives nothing to read, and
each reader then returns None."""
import numpy as np


def span_mean_ms(ctx, key: str):
    """The mean over completed queries of ``timings[key]``, in ms."""
    vals = [r.timings[key] for r in ctx.window.completed if key in r.timings]
    return float(np.mean(vals)) * 1e3 if vals else None


def counters() -> dict:
    try:
        from repro_torch.obs.telemetry import window_log
    except ImportError:
        return {}
    return window_log().counters


def share(part: str, whole: str):
    """100 * counter ``part`` / counter ``whole``, or None without ``whole``."""
    c = counters()
    return 100.0 * c.get(part, 0) / c[whole] if c.get(whole) else None
