"""Batched edit-distance row sweeps on the device (window placement).

The port of raven_tpu/ops/jax_dp.py: `boundary_crossings_device`
(_rows_scan), the polisher's exact alignment-path crossings
(align_dp.batched_boundary_crossings, same contract) as two global
edit-distance DP sweeps over a [B, Q+1] front, forward and on the
reversed sequences, and a host combine; and `infix_align_device`
(_infix_scan), align_dp.batched_infix_align's contract.  Each DP row is a
handful of torch ops with a row-wise `torch.cummin` for the horizontal
closure; the rows are a Python loop.  The crossings' shapes are padded to
the same power-of-two buckets as the JAX function, so the output is
identical.

`DEVICE_RUNS` counts calls that ran on a CUDA device, so a run can show
that its window placement went through the card.
"""

from __future__ import annotations

import numpy as np
import torch

DEVICE_RUNS = 0


def _pow2(x: int, floor: int) -> int:
    b = floor
    while b < x:
        b *= 2
    return b


def rows_scan(tg: torch.Tensor, qr: torch.Tensor, rows_needed: torch.Tensor):
    """Global edit-distance DP over tg [B, T] (row r consumed at step r)
    against qr [B, Q]; returns [B, Q+1] int32, the DP row after
    rows_needed[b] target characters (D[0] = iota).  The counterpart of
    jax_dp._rows_scan; rows past the largest rows_needed are not run, as
    they cannot change the output.  Integer arithmetic only (the mismatch
    is min(|q - t|, 1)), and each row is kept only for the jobs that need
    it."""
    B, T = tg.shape
    Q = qr.shape[1]
    dev = tg.device
    # distances stay within T + Q: int16 holds them at the polisher's sizes
    vt = torch.int16 if T + Q < (1 << 15) - 1 else torch.int32
    idx = torch.arange(Q + 1, dtype=vt, device=dev)
    prev = idx.expand(B, Q + 1).contiguous()
    out = prev.clone()
    need = rows_needed.to(torch.int64).cpu()
    n_rows = min(int(need.max()), T) if B else 0
    # the jobs whose row is r + 1, for every r: one host pass over need
    order = torch.argsort(need, stable=True)
    bounds = torch.searchsorted(need[order], torch.arange(1, n_rows + 2))
    order = order.to(dev)
    t_all = tg.to(vt)
    q_all = qr.to(vt)
    cur = torch.empty((B, Q + 1), dtype=vt, device=dev)
    for r in range(n_rows):
        mism = (q_all - t_all[:, r : r + 1]).abs_().clamp_(max=1)
        cur[:, 0] = r + 1
        torch.minimum(prev[:, :-1] + mism, prev[:, 1:] + 1, out=cur[:, 1:])
        prev = torch.cummin(cur - idx, dim=1).values.add_(idx)
        lo, hi = int(bounds[r]), int(bounds[r + 1])
        if hi > lo:
            hit = order[lo:hi]
            out[hit] = prev[hit]
    return out.to(torch.int32)


def boundary_crossings_device(
    targets: np.ndarray,
    t_lens: np.ndarray,
    queries: np.ndarray,
    q_lens: np.ndarray,
    crosses: np.ndarray,
    device,
) -> np.ndarray:
    """Torch-backed align_dp.batched_boundary_crossings (same contract) on
    `device`: two rows_scan sweeps and the host combine of
    raven_tpu/ops/jax_dp.py::boundary_crossings_device."""
    global DEVICE_RUNS
    device = torch.device(device)
    B0, T0 = targets.shape
    Q0 = queries.shape[1]
    T = _pow2(max(T0, 1), 64)
    Q = _pow2(max(Q0, 1), 64)
    B = _pow2(B0, 256)
    tg = np.full((B, T), 250, dtype=np.uint8)
    tg[:B0, :T0] = targets
    qr = np.full((B, Q), 251, dtype=np.uint8)
    qr[:B0, :Q0] = queries
    rt = np.full((B, T), 250, dtype=np.uint8)
    rq = np.full((B, Q), 251, dtype=np.uint8)
    for b in range(B0):
        tl, ql = int(t_lens[b]), int(q_lens[b])
        rt[b, :tl] = targets[b, :tl][::-1]
        rq[b, :ql] = queries[b, :ql][::-1]
    cr = np.zeros(B, dtype=np.int32)
    cr[:B0] = crosses
    bk = np.zeros(B, dtype=np.int32)
    bk[:B0] = t_lens - crosses

    def sweep(t, q, rows):
        return rows_scan(
            torch.from_numpy(t).to(device),
            torch.from_numpy(q).to(device),
            torch.from_numpy(rows).to(device),
        )[:B0].cpu().numpy()

    fwd = sweep(tg, qr, cr)
    bwd = sweep(rt, rq, bk)
    if device.type == "cuda":
        DEVICE_RUNS += 1
    idx = np.arange(Q + 1, dtype=np.int64)
    j2 = q_lens[:, None].astype(np.int64) - idx[None, :]
    valid = j2 >= 0
    j2 = np.clip(j2, 0, Q)
    total = np.where(
        valid, fwd + bwd[np.arange(B0)[:, None], j2], np.int32(1 << 20)
    )
    return np.argmin(total, axis=1).astype(np.int64)


# infix keys: ((val + _OFFSET) << _SHIFT) | start (val < _OFFSET, Q < 2^13)
_SHIFT = 13
_OFFSET = 4096
_BIG = 4000  # sentinel distance (< _OFFSET)


def infix_scan(targets, t_lens, queries, q_lens):
    """Infix edit-distance DP of targets [B, T] (row t_lens[b] ends the
    target) inside queries [B, Q] (free prefix and suffix; pad never
    matches), int32 on one device: (dist, q_start, q_end) [B] int64, the
    counterpart of jax_dp._infix_scan.  A row's horizontal closure is a
    cummin of packed (value - column, start) keys, which equals the
    associative min-scan on those keys; ties prefer the diagonal.  Rows
    past the longest target are not run, as they cannot change the
    output."""
    B, T = targets.shape
    Q = queries.shape[1]
    dev = targets.device
    i32 = torch.int32
    idx = torch.arange(Q + 1, dtype=i32, device=dev)
    prev_v = torch.zeros((B, Q + 1), dtype=i32, device=dev)
    prev_s = idx.expand(B, Q + 1).contiguous()
    empty = (t_lens == 0)[:, None]
    res_v = torch.where(empty, prev_v, _BIG)
    res_s = torch.where(empty, prev_s, 0)
    n_rows = min(int(t_lens.max()), T) if B else 0
    for r in range(n_rows):
        sub_v = prev_v[:, :-1] + (queries != targets[:, r : r + 1]).to(i32)
        up_v = prev_v[:, 1:] + 1
        take_up = up_v < sub_v
        cur_v = torch.cat([prev_v[:, :1] + 1, torch.where(take_up, up_v, sub_v)], dim=1)
        cur_s = torch.cat([prev_s[:, :1], torch.where(take_up, prev_s[:, 1:], prev_s[:, :-1])],
                          dim=1)
        key = torch.cummin(((cur_v - idx + _OFFSET) << _SHIFT) | cur_s, dim=1).values
        prev_v = (key >> _SHIFT) - _OFFSET + idx
        prev_s = key & ((1 << _SHIFT) - 1)
        hit = (t_lens == r + 1)[:, None]
        res_v = torch.where(hit, prev_v, res_v)
        res_s = torch.where(hit, prev_s, res_s)
    res_v = torch.where(idx[None, :] > q_lens[:, None], _BIG, res_v)
    q_end = torch.argmin(res_v, dim=1)  # ties: the first minimum
    rows = torch.arange(B, device=dev)
    return (res_v[rows, q_end].to(torch.int64), res_s[rows, q_end].to(torch.int64),
            q_end.to(torch.int64))


def infix_align_device(targets: np.ndarray, t_lens: np.ndarray, queries: np.ndarray,
                       q_lens: np.ndarray, device=None):
    """Torch-backed align_dp.batched_infix_align (same contract) on
    `device` (CUDA unless the caller asks for the CPU): the port of
    jax_dp.infix_align_device.  Returns (dist, q_start, q_end) int64
    numpy arrays."""
    from raven_tpu_torch.device import resolve_device

    device = resolve_device(device)
    B, T0 = targets.shape
    Q0 = queries.shape[1]
    if Q0 >= 1 << _SHIFT:
        raise ValueError(f"the packed keys hold Q < {1 << _SHIFT}, got Q={Q0}")
    qr = np.full((B, max(Q0, 1)), -1, dtype=np.int32)  # pad never matches
    qr[:, :Q0] = queries
    out = infix_scan(
        torch.from_numpy(np.asarray(targets, dtype=np.int32)).to(device),
        torch.from_numpy(np.asarray(t_lens, dtype=np.int32)).to(device),
        torch.from_numpy(qr).to(device),
        torch.from_numpy(np.asarray(q_lens, dtype=np.int32)).to(device),
    )
    return tuple(t.cpu().numpy() for t in out)
