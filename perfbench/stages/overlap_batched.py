"""The construct's all-vs-all overlap pass (stage -5 part 1) over a read set
larger than one index batch, so the pass streams the reads through the
index in batches and each later batch maps the earlier batches' reads too
(foreign queries).

The unit, its inputs, its spans and its work are stages/overlap.py's: one
`graph/construct.py::find_overlaps_and_create_piles` call over every read,
as `construct_graph` makes it, the program on its own defaults (the index
batch's budget among them).  The check holds the sampled reads' capped
overlap lists and pile rows against the batched reference
(reference/overlaps_batched.py), which freezes the budget, so a program
whose budget moved fails; and it counts the maps that left the device
(`MinimizerIndex.host_maps` and `host_declines`, over the set-up and the
window): none may.  A program without `host_maps` cannot say where its maps
ran, and the set-up stops at once, before any input is made.

The warm-up is one pass over a prefix of the reads (WARM_BASES, within one
batch, above the engine's host-index size), its overlaps discarded.
"""

from __future__ import annotations

import numpy as np

from perfbench.reference import overlaps as ref
from perfbench.reference import overlaps_batched as ref_batched
from perfbench.stages import overlap as single

WARM_BASES = 1 << 27

unit = single.unit
release = single.release


def _route_counts() -> int:
    from raven_tpu_torch.overlap.engine import MinimizerIndex

    return int(MinimizerIndex.host_maps) + int(MinimizerIndex.host_declines)


def inputs(ctx) -> dict:
    """stages/overlap.py's inputs, and the route counters as they stand."""
    state = single.inputs(ctx)
    state["routes"] = _route_counts()
    return state


def setup(ctx) -> dict:
    from raven_tpu_torch.overlap.engine import MinimizerIndex

    if not hasattr(MinimizerIndex, "host_maps"):
        raise SystemExit(
            "[perfbench] overlap_batched: the program has no MinimizerIndex.host_maps, so a "
            "run cannot show which route its maps took; this cell cannot be measured")
    state = inputs(ctx)
    ctx.inputs_ready()
    rs = state["readset"]
    m = max(1, int(np.searchsorted(np.cumsum(rs.lengths),
                                   min(WARM_BASES, ref_batched.INDEX_BATCH_BASES // 2))))
    prefix = type(rs)(rs.names[:m], rs.starts[:m], rs.lengths[:m], rs.codes, rs.quals)
    unit({"readset": prefix, "sample": [], "records": []}, ctx)
    return state


def _reference(state, ctx, budget_div: int = 1, foreign: bool = True):
    return ref_batched.Index(state["codes"], state["lens"], state["sample"], ref.KMER_LEN,
                             ref.WINDOW_LEN, ref.FREQ, ctx.device,
                             budget=ref_batched.INDEX_BATCH_BASES, budget_div=budget_div,
                             foreign=foreign)


def check(state, ctx):
    """Each sampled read's capped overlap list and pile row, in every unit,
    against the batched reference's; and the maps that took the host
    route."""
    routes = _route_counts() - state["routes"]
    cap = ref.MAX_NUM_OVERLAPS
    index = _reference(state, ctx)
    ctx.data["entries"] = index.entries
    wrong_ovl = wrong_pile = 0
    failed = set()
    for r in state["sample"]:
        full = ref.read_overlaps(index, r)
        row = ref.pile_row(state["lens"][r], full)
        for u, rec in enumerate(state["records"]):
            got, pile = rec[r]
            if not ref.capped_matches(got, full, cap):
                wrong_ovl += 1
                failed.add(u)
            if not np.array_equal(pile, row):
                wrong_pile += 1
                failed.add(u)
    return ({"overlap_reads_wrong": (wrong_ovl, 0), "pile_reads_wrong": (wrong_pile, 0),
             "host_route_maps": (routes, 0)}, len(failed))


# the reference in the program's place with one guarantee of the pass
# broken: the later batches map only their own reads (the pairs of an
# earlier batch's read with a later batch's are lost), or the queries map
# with half their minhash budget
CONTROLS = {"foreign-dropped": {"foreign": False}, "minhash-half": {"budget_div": 2}}


def control(state, ctx, kind: str) -> None:
    """Leaves the control's answers as the one unit's record."""
    cap = ref.MAX_NUM_OVERLAPS
    index = _reference(state, ctx, **CONTROLS[kind])
    rec = {}
    for r in state["sample"]:
        full = ref.read_overlaps(index, r)
        order = np.argsort(-ref.overlap_length(full), kind="stable")[:cap]
        rec[r] = (full[order], ref.pile_row(state["lens"][r], full))
    state["records"] = [rec]
