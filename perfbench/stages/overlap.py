"""The construct's all-vs-all overlap pass (stage -5 part 1) over a read set.

Inputs: the configuration's genome and reads (gen.py).  One unit of work is
one `graph/construct.py::find_overlaps_and_create_piles` call over every
read, as `construct_graph` makes it: `OverlapPhaseCfg()`, a fresh
`MinimizerIndex` of its k and w on the card, fresh `Piles` and per-read
overlap lists.  The reference holds that pass's settings as constants of
its own (reference/overlaps.py), so a program whose defaults moved fails
the check.  Its work is the read bases it
took.  In a traced run the index's `minimize`, `filter` and `map_many`
are spans of their own, each ended on an idle device.  The answers kept
for the check are the sampled reads' overlap lists and pile rows of every
unit.
"""

from __future__ import annotations

import numpy as np

from perfbench import gen
from perfbench.reference import overlaps as ref


def _spanned(ctx, name, fn):
    def call(*args, **kwargs):
        with ctx.span(name):
            return fn(*args, **kwargs)
    return call


def inputs(ctx) -> dict:
    """The read set from the seed, and the reads the check samples."""
    from raven_tpu_torch.io.readset import ReadSet

    cfg, tr = ctx.config, ctx.traffic
    g = gen.generator(ctx.seed, ctx.device)
    genome, _ = gen.make_genome(g, cfg["sequences"], cfg.get("repeat"), ctx.device,
                                cfg.get("tandem"))
    codes, lens = gen.simulate_reads(g, genome, gen.sequence_sizes(cfg), cfg["reads"])
    del genome
    n = lens.size
    starts = np.concatenate([[0], np.cumsum(lens)[:-1]]).astype(np.int64)
    readset = ReadSet([f"r{i}" for i in range(n)], starts, lens, codes, np.empty(0, np.uint8))
    rng = np.random.default_rng([ctx.seed, 1])
    sample = np.union1d(rng.choice(n, min(int(tr["sample_reads"]), n), replace=False),
                        [int(np.argmax(lens))])
    ctx.data.update(bases=int(lens.sum()), reads=n, k=ref.KMER_LEN, w=ref.WINDOW_LEN)
    return {"readset": readset, "codes": codes, "lens": lens, "sample": sample.tolist(),
            "records": []}


def setup(ctx) -> dict:
    state = inputs(ctx)
    ctx.inputs_ready()
    unit(state, ctx)
    state["records"].clear()
    return state


def unit(state, ctx) -> dict:
    from raven_tpu_torch.config import OverlapPhaseCfg
    from raven_tpu_torch.graph import construct
    from raven_tpu_torch.overlap.engine import MinimizerIndex
    from raven_tpu_torch.overlap.types import OVERLAP_DTYPE
    from raven_tpu_torch.pile.pile import Piles

    readset = state["readset"]
    state.pop("last", None)
    cfg = OverlapPhaseCfg()
    with ctx.span("pass"):
        index = MinimizerIndex(cfg.kmer_len, cfg.window_len, device=ctx.device)
        if ctx.tracing:
            for attr, name in (("minimize", "minimize"), ("filter", "filter"),
                               ("map_many", "map")):
                setattr(index, attr, _spanned(ctx, name, getattr(index, attr)))
        piles = Piles(readset.lengths)
        overlaps = [np.zeros(0, dtype=OVERLAP_DTYPE) for _ in range(len(readset))]
        construct.find_overlaps_and_create_piles(index, readset, cfg, piles, overlaps)
        del index
    state["last"] = (overlaps, piles)
    state["records"].append({r: (overlaps[r].copy(), piles.row(r).copy())
                             for r in state["sample"]})
    return {"overlap_bases_per_s": ctx.data["bases"]}


def release(state) -> None:
    state.pop("last", None)
    state.pop("readset", None)


def _reference(state, ctx, budget_div: int = 1):
    return ref.Index(state["codes"], state["lens"], ref.KMER_LEN, ref.WINDOW_LEN, ref.FREQ,
                     ctx.device, budget_div)


def check(state, ctx):
    """Each sampled read's capped overlap list and pile row, in every unit,
    against the reference's."""
    cap = ref.MAX_NUM_OVERLAPS
    index = _reference(state, ctx)
    ctx.data["entries"] = int(index.h.numel())
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
    return {"overlap_reads_wrong": (wrong_ovl, 0), "pile_reads_wrong": (wrong_pile, 0)}, len(failed)


# the reference in the program's place with one guarantee of the pass
# broken: the queries map with half their minhash budget (an approximate
# answer for a faster map)
CONTROLS = {"minhash-half": {"budget_div": 2}}


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
