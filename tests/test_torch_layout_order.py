"""The float order of the port's layout n-body
(raven_tpu_torch/ops/layout_cuda.py), pinned against raven_tpu's jitted
n-body (raven_tpu/graph/layout.py::_device_layout_fn) on the CPU.

The rules were read from XLA:CPU's fusions of raven_tpu's loop under jax
0.9.0 (JAX_READ; layout_cuda.py's module docstring says how).  The plain
version must give raven_tpu's bits on a 1,500-node component (its row sums
take two levels of 32-wide windows), and each rule, swapped for the
nearest other, must not: so raven_tpu's bits pin every rule.  When a jax upgrade
changes XLA's order, test_plain_version_gives_raven_tpus_bits fails first,
names the jax versions and lists the swapped rules that now give
raven_tpu's bits.  The float32 FMA and square root that the rules need are
held to exact rational arithmetic."""

from fractions import Fraction

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from raven_tpu.graph import layout as jlayout  # noqa: E402
from raven_tpu_torch.ops import layout_cuda  # noqa: E402
from tests.torch_layout_repeats import _one_torch_thread  # noqa: E402, F401

JAX_READ = "0.9.0"  # the jax whose XLA:CPU fusions the rules were read from
N = 1500
ITERS = 2  # the second iteration reads the float32 temperature

# each rule of the plain version, and the nearest other rule
SWAPS = {
    "pair_dist2": lambda dx, dy: dx * dx + dy * dy,  # no FMA
    "link_dist2": lambda ax, ay: layout_cuda.fma32(ay, ay, ax * ax),  # an FMA
    "disp_length2": lambda rx, ry: rx * rx + ry * ry,  # no FMA
    "move": lambda step, r, p: step * r + p,  # no FMA
    "window_sums": lambda x: layout_cuda._in_order(x),  # one level, in order
    "WIN": 16,  # windows of 16 columns
    "temperatures": lambda k: [np.float32(0.1 - i * 0.1 / (k + 1)) for i in range(k)],
}


@pytest.fixture(scope="module")
def component():
    """A 1,500-node component (a chain and 2,000 random links), its points,
    and raven_tpu's jitted n-body after ITERS iterations."""
    rng = np.random.default_rng(11)
    pts = rng.random((N, 2))
    ea = np.concatenate([np.arange(N - 1), rng.integers(0, N, 2000)]).astype(np.int64)
    eb = np.concatenate([np.arange(1, N), rng.integers(0, N, 2000)]).astype(np.int64)
    want = jlayout._layout_component(pts.copy(), ea, eb, ITERS)
    return torch.as_tensor(pts, dtype=torch.float32), ea, eb, want


def _swapped(monkeypatch, name, pts, ea, eb):
    with monkeypatch.context() as mp:
        mp.setattr(layout_cuda, name, SWAPS[name])
        return layout_cuda.n_body_plain(pts, ea, eb, ITERS).numpy()


def test_plain_version_gives_raven_tpus_bits(component, monkeypatch):
    pts, ea, eb, want = component
    got = layout_cuda.n_body_plain(pts, ea, eb, ITERS).numpy()
    if not np.array_equal(got, want):
        now = [name for name in SWAPS
               if np.array_equal(_swapped(monkeypatch, name, pts, ea, eb), want)]
        pytest.fail(
            f"the plain n-body differs from raven_tpu's in {int((got != want).sum())} of "
            f"{got.size} coordinates: XLA's float order has changed since jax {JAX_READ} "
            f"(this is jax {jax.__version__}); swapped rules that give raven_tpu's bits: "
            f"{now or 'none'} (read the fusions again, layout_cuda.py's docstring)"
        )


@pytest.mark.parametrize("name", list(SWAPS))
def test_each_rule_is_needed(component, monkeypatch, name):
    """The rule swapped for its nearest other gives other bits than
    raven_tpu's: the component tells the two apart."""
    pts, ea, eb, want = component
    got = _swapped(monkeypatch, name, pts, ea, eb)
    assert np.isfinite(got).all()
    assert not np.array_equal(got, want), f"{name} swapped still gives raven_tpu's bits"


def _nearest_f32(x: Fraction) -> np.float32:
    """float32 round-to-nearest-even of an exact rational."""
    r = np.float32(float(x))
    best = None
    for c in (np.nextafter(r, np.float32(-np.inf)), r, np.nextafter(r, np.float32(np.inf))):
        d = abs(Fraction(float(c)) - x)
        even = (np.array(c).view(np.uint32) & 1) == 0
        if best is None or d < best[0] or (d == best[0] and even):
            best = (d, c)
    return best[1]


def test_fma32_rounds_once():
    """fma32 against the exact a * b + c rounded to float32: random
    operands of mixed scales and signs, results in float32's subnormal
    range, and a case where rounding the float64 sum again gives the wrong
    neighbour (a * b + c = 1 + 2^-24 + 2^-54: the float64 sum is the
    midpoint 1 + 2^-24, whose even neighbour is 1, but the exact value
    rounds up)."""
    rng = np.random.default_rng(5)
    m = 4000
    a = (rng.standard_normal(m) * 2.0 ** rng.integers(-30, 30, m)).astype(np.float32)
    b = (rng.standard_normal(m) * 2.0 ** rng.integers(-30, 30, m)).astype(np.float32)
    c = (rng.standard_normal(m) * 2.0 ** rng.integers(-60, 60, m)).astype(np.float32)
    # 2^30 + 1 = 1047553 * 1025, so this a * b is 2^-24 + 2^-54 exactly
    a[0], b[0], c[0] = np.float32(1047553 * 2.0 ** -20), np.float32(1025 * 2.0 ** -34), 1.0
    a[1:4], b[1:4] = np.float32(3e-20), np.float32([7e-21, -7e-21, 1e-25])
    c[1:4] = np.float32([1e-41, 2e-40, -3e-44])  # subnormal results
    got = layout_cuda.fma32(*(torch.as_tensor(x) for x in (a, b, c))).numpy()
    want = np.array([_nearest_f32(Fraction(float(x)) * Fraction(float(y)) + Fraction(float(z)))
                     for x, y, z in zip(a, b, c)], dtype=np.float32)
    np.testing.assert_array_equal(got, want)
    twice = (a[0].astype(np.float64) * b[0] + c[0]).astype(np.float32)
    assert got[0] == np.float32(1 + 2.0 ** -23) != twice


def test_sqrt32_rounds_once():
    """sqrt32 against the exact nearest float32 of the root (the float32
    r with the least |r^2 - x| among a candidate and its neighbours, since
    no float32 midpoint squares to a float32), over ranges where torch's
    own square root is not always correctly rounded."""
    rng = np.random.default_rng(6)
    x = np.concatenate([rng.random(3000), rng.random(1000) * 1e-6, rng.random(1000) * 1e4,
                        [0.0, 1e-38, 2.0, 0.0001]]).astype(np.float32)
    got = layout_cuda.sqrt32(torch.as_tensor(x)).numpy()
    for xi, r in zip(x, got):
        fx = Fraction(float(xi))
        near = [np.nextafter(r, np.float32(-np.inf)), r, np.nextafter(r, np.float32(np.inf))]
        errs = [abs(Fraction(float(c)) ** 2 - fx) for c in near if c >= 0]
        assert abs(Fraction(float(r)) ** 2 - fx) == min(errs), (xi, r)


def test_n_body_takes_the_plain_version_on_the_cpu(component):
    pts, ea, eb, _ = component
    pts = pts[:600]
    keep = (ea < 600) & (eb < 600)
    runs = layout_cuda.LAUNCHES["n_body"]
    got = layout_cuda.n_body(pts, ea[keep], eb[keep], 3)
    assert layout_cuda.LAUNCHES["n_body"] == runs  # counts launches on the card only
    assert torch.equal(got, layout_cuda.n_body_plain(pts, ea[keep], eb[keep], 3))
    with pytest.raises(ValueError):
        layout_cuda.n_body(pts.to("meta"), ea[keep], eb[keep], 3)
    # K12's wrapper checks what it hands the card before it touches it
    with pytest.raises(ValueError, match="link endpoints"):
        layout_cuda.n_body_kernel(pts, ea[keep], eb[keep] + 600, 3)
    with pytest.raises(TypeError):
        layout_cuda.n_body_kernel(pts.double(), ea[keep], eb[keep], 3)
