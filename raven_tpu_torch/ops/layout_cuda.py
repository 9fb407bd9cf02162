"""The layout n-body: kernel K12 and its plain PyTorch version, both in
raven_tpu's own float32 order.

`n_body(points, edges_a, edges_b, num_iterations)` is the port of
raven_tpu/graph/layout.py::_device_layout_fn: Fruchterman-Reingold
iterations over one component, exact dense repulsion, attraction along the
links.  On a CUDA tensor it launches the hand-written kernel in
raven_tpu_torch/csrc/layout.cu (one cooperative launch for all
iterations, of the blocks `launch_plan` picks from the card) or raises;
on a CPU tensor it runs `n_body_plain`, the same arithmetic in torch ops.
Both give the bits raven_tpu's jitted loop gives on an x86 host with
FMA.

The n-body is chaotic (a last-bit difference grows ~2.5x an iteration), so
the same positions after 100 iterations need the same roundings in the same
order.  XLA:CPU's are read from its fusions of raven_tpu's loop (jax
0.9.0; `XLA_FLAGS=--xla_dump_to=DIR`, the `*.ir-with-opt.ll` of each fusion
of `jit_run`, where the backend turns an fadd fed by an fmul of the same
fusion into an FMA):
  * the repulsion's squared distance is fma(dy, dy, dx * dx), its term
    (delta * inv) rounded before it is added;
  * the row sum is a reduce-window of 32 columns from column 0, each window
    summed in column order from +0, again over windows of 32 of those sums
    while more than 32 remain, and the last sums in order from +0 (the
    padding to a power of two of at least 512 points adds +0 at the end of
    a row, so it changes no bit and is left out here);
  * the attraction is scattered onto the row sum itself, one link at a time
    in link order, with a squared distance of two rounded products (no FMA:
    the products are shuffled out of one vector before the add);
  * the update is fma(t / len, disp, points), len the root of fma(dy, dy,
    dx * dx) of the displacement;
  * the temperature is carried in float32: t <- t - float32(0.1 / (iters +
    1)) from float32(0.1).
tests/test_torch_layout_order.py holds each of these against raven_tpu's
jitted expressions, so a jax upgrade that changes the order fails there
first.

`LAUNCHES` counts kernel launches, so a run can show that its main path
went through the kernel.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

WIN = 32  # XLA:CPU's reduce-window of a row sum
LAUNCHES = {"n_body": 0}
INDEX_MAX = 2 ** 31 - 64  # point indices and window starts are int32
# the plain version's repulsion goes a block of rows at a time, about this
# many pair terms a block: few enough to stay in a CPU's cache, and on the
# card enough for a whole component at the sizes the assembler lays out
_BLOCK_TERMS = 1 << 16
_BLOCK_TERMS_CARD = 1 << 24
_F32, _F64 = torch.float32, torch.float64
_INF = float("inf")


def attraction_slots(n: int, edges_a: np.ndarray, edges_b: np.ndarray) -> np.ndarray:
    """[n, D] partner index per node and attraction link (-1 = none), in
    link order and front-filled: raven_tpu scatter-adds the links in their
    order, so each node sums its own in that order."""
    order = np.argsort(edges_a, kind="stable")
    a = edges_a[order]
    deg = np.bincount(a, minlength=n)
    D = max(1, int(deg.max(initial=0)))
    first = np.concatenate([[0], np.cumsum(deg)[:-1]])
    slot = np.arange(a.size) - first[a]
    out = np.full((n, D), -1, dtype=np.int64)
    out[a, slot] = edges_b[order]
    return out


def scales(n: int) -> tuple[np.float32, np.float32]:
    """(k, k * k) in float32: k = sqrt(float32(1 / n)), as raven_tpu's
    jnp.sqrt(1.0 / n_real)."""
    k = np.sqrt(np.float32(1) / np.float32(n))
    return k, np.float32(k * k)


def temperatures(num_iterations: int) -> list[np.float32]:
    """Each iteration's float32 temperature: raven_tpu carries t in
    float32 from 0.1 and subtracts float32(0.1 / (num_iterations + 1))."""
    t, dt = np.float32(0.1), np.float32(0.1 / (num_iterations + 1))
    out = []
    for _ in range(num_iterations):
        out.append(t)
        t = np.float32(t - dt)
    return out


def fma32(a, b, c, small: bool = True):
    """float32 a * b + c rounded once, on float32 tensors.  a * b is exact
    in float64 and the float64 sum rounds once; rounding that to float32
    again is right unless it lies on a float32 midpoint (or, with `small`,
    in float32's subnormal range), where the float64 sum is rounded to odd
    first: one ulp toward its exact error (TwoSum) when it was inexact and
    even.  small=False is for sums whose values below 2^-126 are all
    clamped alike afterwards."""
    a64 = a.to(_F64)
    p = a64 * (a64 if b is a else b.to(_F64))
    c = c.to(_F64)
    s = p + c
    odd = (s.view(torch.int64) & 0x1FFFFFFF) == 0x10000000
    if small:
        odd |= (s.abs() < 2.0 ** -126) & (s != 0)
    if not bool(odd.any()):
        return s.to(_F32)
    idx = odd.nonzero(as_tuple=True)
    ps, cs, ss = p[idx], c[idx], s[idx]
    bb = ss - ps
    err = (ps - (ss - bb)) + (cs - bb)
    step = (err != 0) & ((ss.view(torch.int64) & 1) == 0)
    toward = torch.where(err > 0, _INF, -_INF).to(_F64)
    s[idx] = torch.where(step, torch.nextafter(ss, toward), ss)
    return s.to(_F32)


def sqrt32(x):
    """float32 square root rounded once (torch's own is not correctly
    rounded on every CPU): the float64 root rounded to float32, moved by one
    ulp where the exact midpoints to its neighbours (squared exactly in
    float64) say it is not the nearest."""
    r = torch.sqrt(x.to(_F64)).to(_F32)
    x64, r64 = x.to(_F64), r.to(_F64)
    up = torch.nextafter(r, torch.full_like(r, _INF))
    dn = torch.nextafter(r, torch.zeros_like(r))
    hi, lo = (r64 + up.to(_F64)) * 0.5, (r64 + dn.to(_F64)) * 0.5
    r = torch.where(hi * hi < x64, up, r)
    return torch.where(lo * lo > x64, dn, r)


def window_sums(x):
    """XLA:CPU's row sum of x [m, rows...] over dim 0: windows of 32 from
    index 0, each summed in order from +0, again while more than 32 sums
    remain, and the last in order from +0.  A shorter last window is what
    padding with +0 gives."""
    while x.shape[0] > WIN:
        m = x.shape[0]
        full = m // WIN * WIN
        sums = []
        if full:
            blocks = x[:full].reshape(full // WIN, WIN, *x.shape[1:])
            sums.append(_in_order(blocks.transpose(0, 1)))
        if full < m:
            sums.append(_in_order(x[full:])[None])
        x = torch.cat(sums)
    return _in_order(x)


def _in_order(x):
    """x [m, ...] summed over dim 0 in order from +0."""
    acc = torch.zeros_like(x[0])
    for t in range(x.shape[0]):
        acc.add_(x[t])
    return acc


# raven_tpu's roundings, one function a rule, so that a test can swap one
# for another and show that raven_tpu's bits tell them apart
def pair_dist2(dx, dy):
    """The repulsion's squared distance: fma(dy, dy, dx * dx) (its values
    below 1e-8 are clamped alike, so the subnormal range needs no care)."""
    return fma32(dy, dy, dx * dx, small=False)


def link_dist2(ax, ay):
    """The attraction's squared distance: two rounded products, no FMA."""
    return ax * ax + ay * ay


def disp_length2(rx, ry):
    """The displacement's squared length: fma(ry, ry, rx * rx)."""
    return fma32(ry, ry, rx * rx)


def move(step, r, p):
    """The update of one coordinate: fma(step, r, p)."""
    return fma32(step, r, p)


def _repulsion_plain(px, py, kk, rows_per_block: int, rows=None):
    """Each row's repulsion sum, (rx, ry) [n] float32 (of `rows` alone, an
    index tensor, when given).  Columns are laid out window-major ([32,
    rows, W], column 32w + t at [t, :, w]) so that each window's running sum
    adds one contiguous slice per column.  The diagonal's term is 0 * inv =
    +0 as it stands; the last window's columns past n are zeroed.  Every
    divisor is a tensor on the device: torch divides a CUDA tensor by a
    scalar as a product with its reciprocal."""
    n = px.shape[0]
    qx, qy = (px, py) if rows is None else (px[rows], py[rows])
    m = qx.shape[0]
    dev = px.device
    W = -(-n // WIN)
    cols = torch.arange(W * WIN, device=dev).clamp(max=n - 1).view(W, WIN).t()
    cx, cy = px[cols][:, None, :], py[cols][:, None, :]  # [32, 1, W]
    pad = n - WIN * (W - 1)  # the last window's real columns
    kk = torch.full((1, 1, 1), float(kk), dtype=_F32, device=dev)
    rx = torch.empty(m, dtype=_F32, device=dev)
    ry = torch.empty(m, dtype=_F32, device=dev)
    for r0 in range(0, m, rows_per_block):
        r1 = min(r0 + rows_per_block, m)
        shape = (WIN, r1 - r0, W)
        dx = torch.sub(qx[None, r0:r1, None], cx, out=torch.empty(shape, device=dev))
        dy = torch.sub(qy[None, r0:r1, None], cy, out=torch.empty(shape, device=dev))
        inv = kk / torch.clamp(pair_dist2(dx, dy), min=1e-8)
        inv[pad:, :, W - 1] = 0.0
        px_w, py_w = _in_order(dx.mul_(inv)), _in_order(dy.mul_(inv))  # [b, W]
        sums = window_sums(torch.stack([px_w, py_w]).permute(2, 0, 1))  # [2, b]
        rx[r0:r1], ry[r0:r1] = sums[0], sums[1]
    return rx, ry


def n_body_plain(points, edges_a, edges_b, num_iterations: int):
    """The n-body in torch ops, raven_tpu's roundings in raven_tpu's order.

    points [n, 2] float32 tensor; edges_a/edges_b int arrays of point
    indices, one attraction link each (node edges_a[e] is pulled toward
    edges_b[e]).  Returns the points after num_iterations iterations,
    float32 [n, 2] on points' device."""
    pts = points.to(_F32)
    n = pts.shape[0]
    k, kk = scales(n)
    # [D, n]: slot j of every node in one contiguous row
    slots = torch.as_tensor(
        attraction_slots(n, np.asarray(edges_a), np.asarray(edges_b)).T.copy(),
        device=pts.device)
    rows_per_block = _rows_per_block(n, pts.device)
    for t in temperatures(num_iterations):
        px, py = pts[:, 0].contiguous(), pts[:, 1].contiguous()
        rx, ry = _repulsion_plain(px, py, kk, rows_per_block)
        pts = _links_and_move(px, py, px, py, rx, ry, slots, k, t)
    return pts


def n_body_rows_plain(points, edges_a, edges_b, rows):
    """Rows `rows` (int array) of n_body_plain(points, edges_a, edges_b, 1):
    the same rules over those rows alone, for a component whose every row
    would take too long.  float32 [len(rows), 2] on points' device."""
    pts = points.to(_F32)
    n = pts.shape[0]
    rows = np.asarray(rows)
    k, kk = scales(n)
    slots = torch.as_tensor(
        attraction_slots(n, np.asarray(edges_a), np.asarray(edges_b))[rows].T.copy(),
        device=pts.device)
    px, py = pts[:, 0].contiguous(), pts[:, 1].contiguous()
    idx = torch.as_tensor(rows, device=pts.device)
    rx, ry = _repulsion_plain(px, py, kk, _rows_per_block(n, pts.device), idx)
    return _links_and_move(px[idx], py[idx], px, py, rx, ry, slots, k, temperatures(1)[0])


def _rows_per_block(n: int, dev) -> int:
    terms = _BLOCK_TERMS if dev.type == "cpu" else _BLOCK_TERMS_CARD
    return max(1, terms // (WIN * -(-n // WIN)))


def _links_and_move(qx, qy, px, py, rx, ry, slots, k, t):
    """Rows (qx, qy) of the points (px, py) moved at temperature t: their
    links (slots [D, rows], -1 past the last) added one at a time in link
    order onto their repulsion sums (rx, ry), then the update.  An empty
    slot adds +0, which changes no sum (none holds -0)."""
    dev = px.device
    linked = slots >= 0
    partner = slots.clamp(min=0)
    k_t = torch.full((1,), float(k), dtype=_F32, device=dev)
    ax = qx[None, :] - px[partner]
    ay = qy[None, :] - py[partner]
    s = -torch.clamp(sqrt32(link_dist2(ax, ay)), min=0.01) / k_t
    cx = torch.where(linked, ax * s, 0.0)
    cy = torch.where(linked, ay * s, 0.0)
    for j in range(slots.shape[0]):
        rx = rx + cx[j]
        ry = ry + cy[j]
    length = sqrt32(disp_length2(rx, ry))
    length = torch.where(length < 0.01, 0.1, length)
    step = torch.full_like(length, float(t)) / length
    return torch.stack([move(step, rx, qx), move(step, ry, qy)], dim=1)


def launch_plan(n: int, sms: int, per_sm: int) -> dict:
    """K12's launch for a component of n points, from the card's SM count
    and the kernel's co-resident blocks an SM: one cooperative grid of as
    many blocks as the card holds at once, at most one a row.  Block b of
    `ctas` owns rows row_ranges(n, ctas)[b].  Any n in [1, INDEX_MAX]."""
    if not 1 <= n <= INDEX_MAX:
        raise ValueError(f"K12 takes 1 to {INDEX_MAX} points, got {n}")
    if per_sm * sms < 1:
        raise ValueError("the card holds no block of K12")
    return {"ctas": min(per_sm * sms, n)}


def row_ranges(n: int, ctas: int) -> list[tuple[int, int]]:
    """The rows [r0, r1) block b of ctas owns, as the kernel splits them."""
    return [(b * n // ctas, (b + 1) * n // ctas) for b in range(ctas)]


_FNS = None
_CARDS: dict[int, dict] = {}
_TEMPS: dict[tuple, torch.Tensor] = {}  # (device, iterations) -> temperatures


def _fns():
    global _FNS
    if _FNS is None:
        from raven_tpu_torch import csrc

        lib = csrc.load("layout")
        card = lib.raven_n_body_card
        card.restype = ctypes.c_int
        card.argtypes = [ctypes.POINTER(ctypes.c_int)] * 2
        fn = lib.raven_n_body_launch
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_float] * 2 + [
            ctypes.c_int, ctypes.c_void_p]
        _FNS = lib, card, fn
    return _FNS


def card_info(device) -> dict:
    """launch_plan's card arguments for a CUDA device, read once a card."""
    from raven_tpu_torch import csrc

    dev = torch.device(device)
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    if index not in _CARDS:
        lib, card, _ = _fns()
        sms, per_sm = ctypes.c_int(0), ctypes.c_int(0)
        with torch.cuda.device(index):
            err = card(ctypes.byref(sms), ctypes.byref(per_sm))
        csrc.check(lib, err, "layout n-body card query")
        _CARDS[index] = {"sms": sms.value, "per_sm": per_sm.value}
    return _CARDS[index]


def n_body_kernel(points, edges_a, edges_b, num_iterations: int):
    """K12 on the card: n_body_plain's arithmetic, one launch for all
    iterations on points' device.  Raises on a failed build or launch."""
    from raven_tpu_torch import csrc

    dev = points.device
    n = points.shape[0]
    if points.dtype != _F32 or tuple(points.shape) != (n, 2):
        raise TypeError(f"points must be [n, 2] float32, got {points.dtype} "
                        f"{tuple(points.shape)}")
    edges_a, edges_b = np.asarray(edges_a), np.asarray(edges_b)
    for e in (edges_a, edges_b):
        if e.size and not (0 <= int(e.min()) and int(e.max()) < n):
            raise ValueError(f"link endpoints must lie in [0, {n}), got "
                             f"[{int(e.min())}, {int(e.max())}]")
    plan = launch_plan(n, **card_info(dev))
    k, kk = scales(n)
    slots = attraction_slots(n, edges_a, edges_b)
    slots_t = torch.as_tensor(np.ascontiguousarray(slots.T, dtype=np.int32), device=dev)
    temps = _TEMPS.get((dev, num_iterations))
    if temps is None:
        temps = torch.as_tensor(np.array(temperatures(num_iterations), dtype=np.float32),
                                device=dev)
        _TEMPS[(dev, num_iterations)] = temps
    # n rounded up to even: the kernel reads two points a 16-byte load
    buf0 = torch.empty((n + n % 2, 2), dtype=_F32, device=dev)
    buf0[:n] = points
    buf1 = torch.empty_like(buf0)
    lib, _, fn = _fns()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(buf0.data_ptr(), buf1.data_ptr(), slots_t.data_ptr(), temps.data_ptr(), n,
                 slots_t.shape[0], num_iterations, float(k), float(kk), plan["ctas"], stream)
    csrc.check(lib, err, f"layout n-body kernel launch ({plan['ctas']} blocks)")
    LAUNCHES["n_body"] += 1
    return (buf1 if num_iterations % 2 else buf0)[:n]


def n_body(points, edges_a, edges_b, num_iterations: int):
    """K12 on a CUDA tensor, its plain version on a CPU tensor."""
    if points.device.type == "cuda":
        return n_body_kernel(points, edges_a, edges_b, num_iterations)
    if points.device.type == "cpu":
        return n_body_plain(points, edges_a, edges_b, num_iterations)
    raise ValueError(f"no layout n-body kernel for device {points.device}")
