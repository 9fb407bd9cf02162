"""K4's share of its roofline, %: the least time the bank's walks need
(rooflines.band_walk_bound; a fragment votes on the consensus rows of its
span; the first iteration on the backbones' lengths, the others on the
call's consensus lengths, each cut to t_pad) over K4's device time in the
trace (every band walk route), per call."""

import numpy as np

from perfbench import rooflines


def read(run):
    if run.trace is None:
        return None
    dev = run.trace.kernel_seconds("band_walk")
    if dev <= 0:
        return None
    d = run.data
    t_pad = run.data["t_pad"]
    bound = 0.0
    for i, lens in enumerate((d["t_lens"], np.minimum(d["out_lens"], t_pad))):
        t = lens[d["frag_win"]]
        voted = np.clip(np.minimum(d["span_end"], t) - d["r0"], 0, None)
        bound += (1 if i == 0 else d["iterations"] - 1) * rooflines.band_walk_bound(
            t, d["q_lens"], voted)["seconds"]
    return 100.0 * bound * len(run.units) / dev
