"""The shift-banded engine's host time a call (ops/consensus_band.py: the
groups' host prep, the launches, the tokens' return), ms: each call's span
less the card's busy time inside it, over the window's calls."""


def read(run):
    if run.trace is None or not run.trace.device_ops:
        return None
    calls = run.trace.spans_named("call")
    if not calls:
        return None
    host = [(e - s) - run.trace.busy_within(s, e) for s, e in calls]
    return 1e3 * sum(host) / len(host)
