"""K3's share of its roofline, %: the least time the bank's forwards need
(rooflines.band_forward_bound; the first iteration on the backbones'
lengths, the others on the call's consensus lengths, each cut to t_pad)
over K3's device time in the trace (every band_forward route), per call."""

import numpy as np

from perfbench import rooflines


def read(run):
    if run.trace is None:
        return None
    dev = run.trace.kernel_seconds("band_forward")
    if dev <= 0:
        return None
    d = run.data
    t_pad = run.data["t_pad"]
    first = rooflines.band_forward_bound(d["t_lens"][d["frag_win"]], d["q_lens"], d["r0"], d["bw"])
    later = rooflines.band_forward_bound(np.minimum(d["out_lens"], t_pad)[d["frag_win"]],
                                         d["q_lens"], d["r0"], d["bw"])
    bound = first["seconds"] + (d["iterations"] - 1) * later["seconds"]
    return 100.0 * bound * len(run.units) / dev
