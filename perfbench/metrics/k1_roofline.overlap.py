"""K1's share of its roofline, %: the least time the pass's sketch needs
(rooflines.sketch_bound over the bases the reads hold and the entries the
reference's sketch of them has) over K1's device time in the trace, per
pass."""

from perfbench import rooflines


def read(run):
    if run.trace is None or "entries" not in run.data:
        return None
    dev = run.trace.kernel_seconds("sketch_rows_kernel")
    if dev <= 0:
        return None
    d = run.data
    bound = rooflines.sketch_bound(d["bases"], d["reads"], d["entries"], d["w"])["seconds"]
    return 100.0 * bound * len(run.units) / dev
