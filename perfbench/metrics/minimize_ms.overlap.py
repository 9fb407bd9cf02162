"""The engine's sketch and index build a pass: MinimizerIndex.minimize and
filter (K1 and the device build on the card), ms, from the stage's spans
(each ended on an idle device), over the window's passes."""


def read(run):
    s = run.span_seconds("minimize") + run.span_seconds("filter")
    return 1e3 * s / len(run.units) if s > 0 else None
