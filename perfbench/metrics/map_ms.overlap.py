"""The engine's all-vs-all map a pass: MinimizerIndex.map_many (the device
index's self-join and the device chain), ms, from the stage's spans (each
ended on an idle device), over the window's passes."""


def read(run):
    s = run.span_seconds("map")
    return 1e3 * s / len(run.units) if s > 0 else None
