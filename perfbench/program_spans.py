"""The program's own spans in a traced run, for the metrics that read them.

The program records a span (raven_tpu_torch.utils.trace) for each of its
steps while a profiler records, with its start and end in Unix-epoch
nanoseconds: the clock of the trace's device events, so a span compares
directly with the traced window.  The metrics split the host's time, and
with it the card's idle time, into the program's steps, so they read runs
on the card: a run that was not traced, a trace with no device work in it
(a CPU run, as device_idle_pct reads none there), or a program without that
module gives no spans, and the metrics read nothing.
"""


def in_window(run) -> list:
    """The program's spans that lie inside the traced window ([] for none)."""
    if run.trace is None or run.trace.window_s <= 0 or not run.trace.device_ops:
        return []
    try:
        from raven_tpu_torch.utils import trace
    except ImportError:
        return []
    lo, hi = (1e9 * t for t in run.trace.window)
    return [r for r in trace.spans() if lo <= r.start and r.end <= hi]


def ms_per(run, name: str, per: str):
    """The spans `name` in the window, in ms summed over them, over the
    number of spans `per` there (a pass, a call); None where either is
    missing."""
    spans = in_window(run)
    n = sum(r.name == per for r in spans)
    parts = [r.end - r.start for r in spans if r.name == name]
    return sum(parts) / 1e6 / n if n and parts else None
