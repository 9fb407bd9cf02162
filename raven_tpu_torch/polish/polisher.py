"""Racon-equivalent consensus polisher.

A copy of raven_tpu/polish/polisher.py with five changes: the mapping
index is the port's engine on the polisher's device; the crossing DP runs
on that device through ops/dp_device.py unless it is the CPU (and raises
on failure); the device consensus's engine and iterations are the class
attributes CONSENSUS_ENGINE and CONSENSUS_ITERS where raven_tpu reads
RAVEN_TPU_CONSENSUS_ENGINE and RAVEN_TPU_CONSENSUS_ITERS; the device
consensus shards its votes over a mesh (Polisher.MESH, or every card when
the device is CUDA and more than one card is visible; False refuses one)
where raven_tpu reads RAVEN_TPU_SHARDED_POLISH; the host fork pool checks
whether CUDA is initialised.

Reference behaviour being reproduced (use site RavenLib/src/polish.cc:43-51
plus the racon library dependency it drives):

  1. map reads to target contigs with the minimizer engine (k=15, w=5,
     freq=0.001), keeping each read's longest overlap;
  2. drop overlaps whose span error 1 - min(span)/max(span) > 0.3;
  3. split every overlap at 500-base target window boundaries (progressive
     piecewise alignment, ops.align_dp — batched across overlaps);
  4. drop fragments shorter than 2% of the window or with mean quality
     below the dataset average;
  5. per-window POA consensus (backbone + fragments, NW 3/-5/-4) with
     coverage trimming; windows with fewer than 2 fragments stay unpolished;
  6. contigs are re-assembled from window consensuses and named with an
     ` XC:f:<polished fraction>` suffix — the value after the last ':'
     is what raven's Polish parses (polish.cc:57-59).
"""

from __future__ import annotations

import numpy as np
import torch

from raven_tpu_torch.device import resolve_device
from raven_tpu_torch.io.readset import reverse_complement
from raven_tpu_torch.overlap.engine import MinimizerIndex
from raven_tpu_torch.overlap.types import overlap_length
from raven_tpu_torch.ops.align_dp import batched_boundary_crossings
from raven_tpu_torch.ops.poa import poa_consensus
from raven_tpu_torch.parallel.mesh import chosen_mesh
from raven_tpu_torch.utils import trace

MAP_K = 15  # read->contig mapping k-mer length (racon's ram default)
WINDOW_LEN = 500  # polish.cc:44 (racon window_length)
ERROR_THRESHOLD = 0.3  # polish.cc:44
MIN_FRAGMENT = int(WINDOW_LEN * 0.02)
POA_BATCH_TARGET = 256  # device batch size for the JAX POA path
_LOG = "[raven_tpu_torch::Polisher]"


_POA_JOBS = None
_POA_SELF = None


def _poa_pool_worker(i):
    _, _, backbone, frag_codes, weights = _POA_JOBS[i][:5]
    s = _POA_SELF
    cons = backbone
    for _ in range(max(1, s.consensus_passes)):
        cons = poa_consensus(
            cons, frag_codes, weights, s.match, s.mismatch, s.gap, s.trim
        )
    return cons


class _SeqView:
    def __init__(self, codes_list):
        self.codes_list = codes_list
        self.lengths = np.array([c.size for c in codes_list], dtype=np.int64)

    def __len__(self):
        return len(self.codes_list)

    def sequence(self, i, begin=0, length=None):
        c = self.codes_list[i]
        if length is None:
            length = c.size - begin
        return c[begin : begin + length]


class Polisher:
    # the mesh of the device consensus's votes: None takes every card when
    # the polisher's device is CUDA and more than one card is visible
    # (raven_tpu's automatic multi-device polish); a Mesh forces it
    # (raven_tpu's RAVEN_TPU_SHARDED_POLISH=1), False refuses it and keeps
    # the one-device votes (RAVEN_TPU_SHARDED_POLISH=0)
    MESH = None
    # the device consensus's engine (raven_tpu's RAVEN_TPU_CONSENSUS_ENGINE):
    # None routes by DeviceCfg, the full-NW engine (anchored-banded with
    # banded_alignment) when poa_batches > 0 or banded_alignment is set,
    # else the shift-banded one; "shiftband" takes the shift-banded engine
    # whatever DeviceCfg says; any other string the full-NW engine, banded
    # only with banded_alignment (raven_tpu's "banded" and "pallas" fall
    # through to full NW, and so do they here)
    CONSENSUS_ENGINE = None
    # the device consensus's refinement iterations (raven_tpu's
    # RAVEN_TPU_CONSENSUS_ITERS)
    CONSENSUS_ITERS = 4

    def __init__(
        self,
        quality_threshold: float = 0.0,
        error_threshold: float = ERROR_THRESHOLD,
        window_len: int = WINDOW_LEN,
        trim: bool = True,
        match: int = 3,
        mismatch: int = -5,
        gap: int = -4,
        use_device: bool | None = None,
        device_cfg=None,
        consensus_passes: int = 2,
        device=None,
    ):
        # the device of the mapping index, the crossing DP and the device
        # consensus (CUDA unless the caller asks for the CPU)
        self.device = resolve_device(device)
        self.quality_threshold = quality_threshold
        self.error_threshold = error_threshold
        self.window_len = window_len
        self.trim = trim
        self.match = match
        self.mismatch = mismatch
        self.gap = gap
        self.use_device = use_device
        # within-window iterative refinement: the second POA pass realigns
        # the fragments against the first pass's consensus as backbone,
        # which converges the window faster than racon's single pass
        # (lambda 2-round golden config: ED 1132 vs reference 1137; a third
        # pass over-refines and regresses)
        self.consensus_passes = consensus_passes
        # DeviceCfg (reference CudaCfg analog, polish.hpp:19-23):
        # poa_batches > 0 forces the batched device consensus (chunk size
        # poa_batches * 256 fragment rows per dispatch), alignment_batches
        # > 0 forces the device window-placement DP, banded_alignment
        # restricts the consensus NW to a diagonal corridor
        self.device_cfg = device_cfg
        # consensus backend override: None = follow use_device/auto; the
        # graph-level driver schedules POA rounds + a device-voting final
        # round (see raven_tpu_torch.polish.polish)
        self.use_device_consensus: bool | None = None
        # the consensus engine of the last polish call: "device" or "host"
        self.last_engine: str | None = None

    # ------------------------------------------------------------------
    def _find_overlaps(self, targets, readset):
        """Longest passing overlap per read with its chain anchors (racon
        keeps each read's best overlap)."""
        view = _SeqView([codes for _, codes in targets])
        index = MinimizerIndex(15, 5, device=self.device)
        index.minimize(view, np.arange(len(targets)))
        index.filter(0.001)

        anchors_map: dict = {}
        results: dict = {}
        CHUNK = 4096  # bound the expanded match arrays
        for c0 in range(0, len(readset), CHUNK):
            results.update(
                index.map_many(
                    readset,
                    np.arange(c0, min(c0 + CHUNK, len(readset))),
                    avoid_equal=False,
                    avoid_symmetric=False,
                    anchors_out=anchors_map,
                )
            )
        chosen = []
        for i in range(len(readset)):
            ovl = results[i]
            if ovl.size == 0:
                continue
            bi = int(np.argmax(overlap_length(ovl)))
            best = ovl[bi]
            lspan = int(best["lhs_end"]) - int(best["lhs_begin"])
            rspan = int(best["rhs_end"]) - int(best["rhs_begin"])
            err = 1.0 - min(lspan, rspan) / max(lspan, rspan)
            if err > self.error_threshold:
                continue
            chosen.append((best, anchors_map[i][bi]))
        return chosen

    # ------------------------------------------------------------------
    MAX_SEG = 6000  # inter-anchor DP segment cap (beyond: interpolate)

    def _fragments(self, overlaps, targets, readset):
        """Window fragments per target via exact alignment break points.

        racon walks one whole-overlap edlib path per read and records where
        it crosses 500-base target boundaries (the racon dependency's
        FindBreakPoints); the TPU-native re-design gets the same crossings
        without any traceback: the chain's minimizer anchors are exact
        k-matches that pin the optimal path, so a boundary either falls
        inside an anchor (crossing is immediate) or inside a short
        inter-anchor segment, where a forward + backward DP row pair gives
        the optimal split (ops.align_dp.batched_boundary_crossings /
        ops.dp_device.boundary_crossings_device).  All segments across all
        overlaps batch into rectangular sweeps.

        Returns {target_id: {window_id: [(win_rel_begin, codes, quals)]}}.
        """
        w = self.window_len
        states = []
        seg_jobs = []  # (state_idx, bound_idx, t0, t1, q0, q1, cross)
        for o, (aq, at) in overlaps:
            rid = int(o["lhs_id"])
            tid = int(o["rhs_id"])
            qb, qe = int(o["lhs_begin"]), int(o["lhs_end"])
            tb, te = int(o["rhs_begin"]), int(o["rhs_end"])
            strand = int(o["strand"])
            q = readset.sequence(rid, qb, qe - qb)
            qq = readset.quality(rid, qb, qe - qb)
            if not strand:
                q = reverse_complement(q)
                qq = qq[::-1] if qq.size else qq
            # anchors in (target_pos, oriented_query_pos), ascending in t
            if strand:
                ta = at.astype(np.int64)
                qa = (aq - qb).astype(np.int64)
            else:
                ta = at[::-1].astype(np.int64)
                qa = (qe - (aq[::-1] + MAP_K)).astype(np.int64)
            # the chain is strictly monotonic in both coords; guard anyway
            keep = np.ones(ta.size, dtype=bool)
            run_t = tb - 1
            run_q = -1
            for i in range(ta.size):
                if ta[i] <= run_t or qa[i] <= run_q or qa[i] >= q.size:
                    keep[i] = False
                else:
                    run_t, run_q = ta[i], qa[i]
            ta, qa = ta[keep], qa[keep]

            bounds = np.arange((tb // w + 1) * w, te, w, dtype=np.int64)
            breaks_q = np.full(bounds.size, -1, dtype=np.int64)
            si = len(states)
            for bi, W in enumerate(bounds):
                i = int(np.searchsorted(ta, W, side="right")) - 1
                if i >= 0 and W - ta[i] <= MAP_K:
                    breaks_q[bi] = qa[i] + (W - ta[i])
                    continue
                # segment between previous pin and the next anchor
                if i >= 0:
                    t0, q0 = int(ta[i]) + MAP_K, int(qa[i]) + MAP_K
                else:
                    t0, q0 = tb, 0
                if i + 1 < ta.size:
                    t1, q1 = int(ta[i + 1]), int(qa[i + 1])
                else:
                    t1, q1 = te, q.size
                t0, q0 = min(t0, t1), min(min(q0, q1), q.size)
                q1 = min(q1, q.size)
                cross = int(W) - t0
                if t1 - t0 > self.MAX_SEG or q1 - q0 > self.MAX_SEG:
                    frac = cross / max(t1 - t0, 1)
                    breaks_q[bi] = q0 + int(frac * (q1 - q0))
                else:
                    seg_jobs.append((si, bi, t0, t1, q0, q1, cross))
            states.append(
                {
                    "tid": tid,
                    "q": q,
                    "qq": qq,
                    "tb": tb,
                    "te": te,
                    "bounds": bounds,
                    "breaks_q": breaks_q,
                }
            )

        self._solve_segments(seg_jobs, states, targets)

        out: dict[int, dict[int, list]] = {}
        for s in states:
            qn = s["q"].size
            bq = np.concatenate([[0], s["breaks_q"], [qn]])
            bq = np.maximum.accumulate(np.clip(bq, 0, qn))
            bt = np.concatenate([[s["tb"]], s["bounds"], [s["te"]]])
            for i in range(bt.size - 1):
                fb, fe = int(bq[i]), int(bq[i + 1])
                if fe - fb < MIN_FRAGMENT:
                    continue
                quals = s["qq"][fb:fe] if s["qq"].size else None
                if (
                    quals is not None
                    and self.quality_threshold > 0
                    and quals.mean() < self.quality_threshold
                ):
                    continue
                win_id = int(bt[i]) // w
                rel = int(bt[i]) % w
                # placement span on the window backbone: [rel, rel_end)
                # — the banded device kernel anchors each fragment's DP
                # corridor on it (partial-window fragments at read ends
                # do NOT follow the whole-window diagonal)
                rel_end = min(int(bt[i + 1]) - win_id * w, w)
                out.setdefault(s["tid"], {}).setdefault(win_id, []).append(
                    (rel, s["q"][fb:fe], quals, rel_end)
                )
        return out

    def _solve_segments(self, seg_jobs, states, targets):
        """Batch the inter-anchor crossing DPs, bucketed by segment size so
        device dispatches reuse a handful of compiled shapes."""
        if not seg_jobs:
            return
        BUCKETS = (64, 256, 1024, self.MAX_SEG + 1)
        by_bucket: dict[int, list] = {}
        for job in seg_jobs:
            _, _, t0, t1, q0, q1, _ = job
            size = max(t1 - t0, q1 - q0)
            for cap in BUCKETS:
                if size <= cap:
                    by_bucket.setdefault(cap, []).append(job)
                    break
        for cap, jobs in by_bucket.items():
            CHUNK = 8192 if cap <= 256 else 1024
            for c0 in range(0, len(jobs), CHUNK):
                chunk = jobs[c0 : c0 + CHUNK]
                B = len(chunk)
                T = max(j[3] - j[2] for j in chunk)
                Q = max(1, max(j[5] - j[4] for j in chunk))
                tg = np.full((B, T), 250, dtype=np.uint8)
                qr = np.full((B, Q), 251, dtype=np.uint8)
                tl = np.zeros(B, dtype=np.int64)
                ql = np.zeros(B, dtype=np.int64)
                cr = np.zeros(B, dtype=np.int64)
                for b, (si, bi, t0, t1, q0, q1, cross) in enumerate(chunk):
                    tgt = targets[states[si]["tid"]][1][t0:t1]
                    qry = states[si]["q"][q0:q1]
                    tg[b, : tgt.size] = tgt
                    qr[b, : qry.size] = qry
                    tl[b] = tgt.size
                    ql[b] = qry.size
                    cr[b] = cross
                crossings = self._crossings(tg, tl, qr, ql, cr)
                for b, (si, bi, t0, t1, q0, q1, cross) in enumerate(chunk):
                    states[si]["breaks_q"][bi] = q0 + int(crossings[b])

    def _crossings(self, tg, tl, qr, ql, cr):
        """Run the crossing DP on the polisher's device unless that is the
        CPU (or the caller says otherwise); a device failure raises."""
        use_dev = self.use_device
        if self.device_cfg is not None and self.device_cfg.alignment_batches > 0:
            use_dev = True
        if use_dev is None:
            use_dev = self.device.type != "cpu"
        if use_dev:
            from raven_tpu_torch.ops.dp_device import boundary_crossings_device

            return boundary_crossings_device(tg, tl, qr, ql, cr, self.device)
        from raven_tpu_torch.ops.align_dp import native_boundary_crossings

        out = native_boundary_crossings(tg, tl, qr, ql, cr)
        if out is not None:
            return out
        return batched_boundary_crossings(tg, tl, qr, ql, cr)

    # ------------------------------------------------------------------
    def polish(self, targets, readset, include_unpolished: bool = False):
        """targets: list of (name, codes).  Returns list of (name', codes')
        where name' carries the ` XC:f:<fraction>` suffix; unpolished
        targets are included only when include_unpolished (the raven call
        site passes False, polish.cc:51)."""
        with trace.span("polish.align") as s:
            overlaps = self._find_overlaps(targets, readset)
            frag_map = self._fragments(overlaps, targets, readset)
            s["reads"] = len(overlaps)
            s.log = f"{_LOG} aligned {len(overlaps)} reads"

        with trace.span("polish.generate", log=f"{_LOG} generated consensus"):
            w = self.window_len
            per_target = []  # (name, codes, pieces, jobs, polished_count)
            all_jobs = []  # (target_idx, slot, backbone, frag_codes, weights)
            for tid, (name, codes) in enumerate(targets):
                windows = frag_map.get(tid, {})
                num_windows = (codes.size + w - 1) // w
                polished_count = 0
                pieces = []
                for win_id in range(num_windows):
                    backbone = codes[win_id * w : min((win_id + 1) * w, codes.size)]
                    frags = sorted(
                        windows.get(win_id, []), key=lambda f: f[0]
                    )
                    if len(frags) < 2:  # racon: < 3 sequences incl. backbone
                        pieces.append(backbone)
                        continue
                    polished_count += 1
                    frag_codes = [f[1] for f in frags]
                    spans = [
                        (f[0], f[3] if len(f) > 3 else backbone.size)
                        for f in frags
                    ]
                    if all(f[2] is not None for f in frags):
                        # spoa weight semantics: the raw phred value (racon
                        # passes quality chars; spoa uses char - 33)
                        weights = [
                            np.minimum(f[2].astype(np.int64), 255).astype(
                                np.uint8
                            )
                            for f in frags
                        ]
                    else:
                        weights = None
                    pieces.append(None)
                    all_jobs.append(
                        (tid, len(pieces) - 1, backbone, frag_codes, weights,
                         spans)
                    )
                per_target.append((name, codes, pieces, polished_count, num_windows))

            with trace.span("polish.consensus", windows=len(all_jobs)):
                consensi = self._run_consensus(all_jobs)
            for (tid, slot, *_), cons in zip(all_jobs, consensi):
                per_target[tid][2][slot] = cons

            results = []
            for name, codes, pieces, polished_count, num_windows in per_target:
                fraction = polished_count / max(num_windows, 1)
                if fraction == 0 and not include_unpolished:
                    continue
                polished = np.concatenate(pieces) if pieces else codes
                results.append((f"{name} XC:f:{fraction:.6f}", polished))
        return results

    # ------------------------------------------------------------------
    def _run_consensus(self, jobs):
        """Dispatch window consensus jobs: the batched device consensus
        when the device is asked for (DeviceCfg.poa_batches > 0 asks for it
        in every round), C++/python POA on the host when it is not.  On the
        device, CONSENSUS_ENGINE picks the engine; by default
        DeviceCfg.poa_batches or banded_alignment (the reference's CUDA-POA
        flags) select raven_tpu's legacy engine, and without either the
        shift-banded consensus runs.  The legacy engine is the full-NW
        window consensus, anchored-banded with banded_alignment, in chunks
        of poa_batches * 256 fragment rows (2048 without poa_batches).
        Either runs CONSENSUS_ITERS iterations and shards its votes over
        the mesh MESH asks for (parallel.mesh.chosen_mesh)."""
        use_dev = self.use_device_consensus
        dc = self.device_cfg
        if dc is not None and dc.poa_batches > 0:
            use_dev = True
        if use_dev is None:
            use_dev = self.use_device
        if use_dev is None:
            use_dev = self.device.type != "cpu"
        if use_dev and jobs:
            windows = [
                (backbone, frag_codes, weights, spans)
                for _, _, backbone, frag_codes, weights, spans in jobs
            ]
            self.last_engine = "device"
            mesh = chosen_mesh(self.MESH, self.device)
            engine = self.CONSENSUS_ENGINE
            if engine is None:
                legacy = dc is not None and (dc.poa_batches > 0 or dc.banded_alignment)
                engine = "full" if legacy else "shiftband"
            if engine != "shiftband":
                from raven_tpu_torch.ops.consensus_device import (
                    device_window_consensus,
                )

                kwargs = {}
                if dc is not None and dc.poa_batches > 0:
                    kwargs["chunk"] = 256 * dc.poa_batches
                return device_window_consensus(
                    windows, iterations=self.CONSENSUS_ITERS,
                    banded=dc is not None and dc.banded_alignment,
                    mesh=mesh, device=self.device, **kwargs,
                )
            from raven_tpu_torch.ops.consensus_band import band_window_consensus

            return band_window_consensus(
                windows, iterations=self.CONSENSUS_ITERS, mesh=mesh, device=self.device
            )
        self.last_engine = "host"
        return self._run_poa_host(jobs)

    def _run_poa_host(self, jobs):
        """C++ POA over all windows; windows are independent, so large
        batches fan out over a thread pool — the ctypes call into the
        native engine releases the GIL, so threads scale like the
        reference's racon thread pool.  (A fork pool is unsafe once CUDA is
        initialised: a forked child must not touch it.)"""
        import os
        import sys

        def run_one(job):
            _, _, backbone, frag_codes, weights = job[:5]
            cons = backbone
            for _ in range(max(1, self.consensus_passes)):
                cons = poa_consensus(
                    cons,
                    frag_codes,
                    weights,
                    self.match,
                    self.mismatch,
                    self.gap,
                    self.trim,
                )
            return cons

        from raven_tpu_torch.config import worker_count
        from raven_tpu_torch.ops.poa import _native_poa

        workers = worker_count()
        use_threads = (
            len(jobs) >= 64
            and workers > 1
            and _native_poa() is not None
            and os.environ.get("RAVEN_TPU_NO_MP") != "1"
        )
        if use_threads:
            from concurrent.futures import ThreadPoolExecutor

            with ThreadPoolExecutor(workers) as pool:
                return list(pool.map(run_one, jobs))
        if (
            len(jobs) >= 64
            and workers > 1
            and sys.platform.startswith("linux")
            and os.environ.get("RAVEN_TPU_NO_MP") != "1"
            and not torch.cuda.is_initialized()
        ):
            import multiprocessing as mp

            global _POA_JOBS, _POA_SELF
            _POA_JOBS = jobs
            _POA_SELF = self
            try:
                ctx = mp.get_context("fork")
                with ctx.Pool(workers) as pool:
                    chunk = max(1, len(jobs) // (workers * 4))
                    return pool.map(_poa_pool_worker, range(len(jobs)), chunk)
            finally:
                _POA_JOBS = None
                _POA_SELF = None
        return [run_one(j) for j in jobs]
