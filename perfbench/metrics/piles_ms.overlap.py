"""The construct driver's own time a pass (graph/construct.py: the new
index, piles and lists, the overlaps dealt to both reads, the layers, the
cap), ms: a pass's span less the engine's spans in it, over the window's
passes."""


def read(run):
    engine = sum(run.span_seconds(n) for n in ("minimize", "filter", "map"))
    s = run.span_seconds("pass") - engine
    return 1e3 * s / len(run.units) if engine > 0 else None
