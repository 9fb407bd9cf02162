"""The window consensus of one polishing round on the shift-banded engine.

Inputs: the window bank of the configuration's draft (gen.window_bank).  One
unit of work is one `ops/consensus_band.py::band_window_consensus` call on
the whole bank, made as `Polisher._run_consensus` makes it once a round:
`Polisher.CONSENSUS_ITERS` iterations and the engine's default shapes.  The
reference holds those settings as constants of its own
(reference/consensus.py), so a program whose defaults moved fails the
check.  Its work is the backbone (draft) bases of the windows it completed.
Every window's consensus of every unit is checked.
"""

from __future__ import annotations

import numpy as np

from perfbench import gen
from perfbench.reference import consensus as ref


def inputs(ctx) -> dict:
    """The window bank from the seed."""
    cfg, tr = ctx.config, ctx.traffic
    g = gen.generator(ctx.seed, ctx.device)
    genome, _ = gen.make_genome(g, cfg["sequences"], cfg.get("repeat"), ctx.device,
                                cfg.get("tandem"))
    windows = gen.window_bank(g, genome, gen.sequence_sizes(cfg), cfg["reads"], tr["draft"],
                              int(tr["window_len"]))
    del genome
    n = len(windows)
    nfrag = np.array([len(w[1]) for w in windows])
    ctx.data.update(
        bases=int(sum(len(w[0]) for w in windows)),
        bw=ref.BW,
        iterations=ref.ITERATIONS,
        t_pad=ref.T_PAD,
        frag_win=np.repeat(np.arange(n), nfrag),
        q_lens=np.minimum(np.concatenate([[len(f) for f in w[1]] for w in windows]), ref.Q_PAD),
        r0=np.clip(np.concatenate([[s[0] for s in w[3]] for w in windows]), 0, ref.T_PAD - 1),
        span_end=np.concatenate([[s[1] for s in w[3]] for w in windows]),
        t_lens=np.minimum([len(w[0]) for w in windows], ref.T_PAD),
    )
    return {"windows": windows, "records": []}


def setup(ctx) -> dict:
    state = inputs(ctx)
    ctx.inputs_ready()
    unit(state, ctx)
    state["records"].clear()
    return state


def unit(state, ctx) -> dict:
    from raven_tpu_torch.ops import consensus_band
    from raven_tpu_torch.polish.polisher import Polisher

    with ctx.span("call"):
        out = consensus_band.band_window_consensus(
            state["windows"], iterations=Polisher.CONSENSUS_ITERS, device=ctx.device)
    ctx.data["out_lens"] = np.array([len(c) for c in out])
    state["records"].append(out)
    return {"polish_bases_per_s": ctx.data["bases"]}


def release(state) -> None:
    pass


def check(state, ctx):
    """Every window's consensus, in every unit, against the reference's."""
    if "want" not in state:  # made once for a seed's controls
        state["want"] = ref.window_consensus(state["windows"], ctx.device)
    want = state["want"]
    wrong = 0
    failed = set()
    for u, got in enumerate(state["records"]):
        for w, cons in enumerate(want):
            if w >= len(got) or not np.array_equal(np.asarray(got[w], np.uint8), cons):
                wrong += 1
                failed.add(u)
    return {"windows_wrong": (wrong, 0)}, len(failed)


# the reference in the program's place with one guarantee of the round
# broken, each a shortcut a faster engine could take: one refinement
# iteration fewer (a less converged consensus); an insertion taken when its
# weight ties a quarter of the adjacent column's, not only past it (the
# vote epilogue's rule off by one); every fragment aligned from its
# window's start, its span dropped (the host prep's placement lost)
CONTROLS = {
    "iterations-1": lambda windows, dev: ref.window_consensus(
        windows, dev, iterations=ref.ITERATIONS - 1),
    "insertion-ties": lambda windows, dev: ref.window_consensus(
        windows, dev, insertion_ties=True),
    "spans-dropped": lambda windows, dev: ref.window_consensus(
        [(w[0], w[1], w[2], None) for w in windows], dev),
}


def control(state, ctx, kind: str) -> None:
    """Leaves the control's answers as the one unit's record."""
    state["records"] = [CONTROLS[kind](state["windows"], ctx.device)]
