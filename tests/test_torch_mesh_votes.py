"""The mesh-summed window votes on the CPU: device_window_consensus(mesh=)
(full-NW and anchored banded) and band_window_consensus(mesh=) on virtual
CPU meshes against the port's single device and raven_tpu's sharded calls
on its 8 virtual devices (tests/conftest.py), bit for bit, and the
Polisher forced onto a mesh (Polisher.MESH) on both engines."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from raven_tpu_torch.io import ReadSet as TReadSet  # noqa: E402
from raven_tpu_torch.parallel.mesh import Mesh  # noqa: E402
from tests.conftest import random_genome, sample_reads  # noqa: E402

MESH8 = Mesh(["cpu"] * 8)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Several xdist workers share the cores; one torch thread each keeps
    their OpenMP threads from spinning against each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _no_reference_env(monkeypatch):
    for name in ("RAVEN_TPU_SHARDED_POLISH", "RAVEN_TPU_CONSENSUS_ENGINE",
                 "RAVEN_TPU_CONSENSUS_ITERS", "RAVEN_TPU_BANDED",
                 "RAVEN_TPU_PALLAS_CONSENSUS", "RAVEN_TPU_CONSENSUS_GROUP"):
        monkeypatch.delenv(name, raising=False)


@pytest.fixture(scope="module")
def jmesh8():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 (virtual) devices")
    from raven_tpu.parallel.mesh import make_mesh

    return make_mesh(8)


def _mutant(rng, truth, dele=0.05, sub=0.04):
    keep = rng.random(truth.size) >= dele
    seg = truth[keep]
    return np.where(rng.random(seg.size) < sub, (seg + 1) % 4, seg).astype(np.uint8)


def _vote_windows(seed, n, spans=False):
    """tests/test_consensus_device.py:172's windows (:259's with spans)."""
    rng = np.random.default_rng(seed)
    windows = []
    for _ in range(n):
        truth = rng.integers(0, 4, 300).astype(np.uint8)
        frags = [_mutant(rng, truth) for _ in range(12)]
        wts = [np.full(f.size, 9, np.uint8) for f in frags]
        w = (_mutant(rng, truth), frags, wts)
        windows.append((*w, [(0, 300)] * 12) if spans else w)
    return windows


@pytest.mark.parametrize("banded", [False, True])
def test_device_window_consensus_mesh(jmesh8, banded):
    """The full-NW and anchored banded votes on 8 virtual devices: the
    port's single device's consensus and raven_tpu's sharded one, bit for
    bit (the rows pad to 8 chunks of 16, most of them qlen 0)."""
    from raven_tpu.ops import consensus_device as jcd
    from raven_tpu_torch.ops import consensus_device as tcd

    windows = _vote_windows(15 if banded else 5, 5 if banded else 6, spans=banded)
    kw = dict(iterations=2, t_pad=384, q_pad=384, chunk=16, banded=banded)
    single = tcd.device_window_consensus(windows, device="cpu", **kw)
    sharded = tcd.device_window_consensus(windows, mesh=MESH8, **kw)
    want = jcd.device_window_consensus(windows, mesh=jmesh8, **kw)
    for a, b, c in zip(single, sharded, want):
        assert np.array_equal(a, b)
        assert np.array_equal(b, c)


def test_band_window_consensus_mesh(jmesh8):
    """tests/test_consensus_band.py:183: the shift-banded loop on 8 virtual
    devices gives the single device's and raven_tpu's sharded consensus;
    so does an uneven split on 3 devices (the 256 rows padded to 258)."""
    from raven_tpu.ops import consensus_band as jb
    from raven_tpu_torch.ops import consensus_band as tb

    rng = np.random.default_rng(5)
    windows = []
    for _ in range(6):
        truth = rng.integers(0, 4, 300).astype(np.uint8)
        frags = [_mutant(rng, truth, 0.05, 0.04) for _ in range(12)]
        wts = [np.full(f.size, 9, np.uint8) for f in frags]
        windows.append((_mutant(rng, truth, 0.05, 0.04), frags, wts))
    kw = dict(iterations=2, t_pad=384, bw=384)
    single = tb.band_window_consensus(windows, device="cpu", **kw)
    sharded = tb.band_window_consensus(windows, mesh=MESH8, **kw)
    three = tb.band_window_consensus(windows, mesh=Mesh(["cpu"] * 3), **kw)
    want = jb.band_window_consensus(windows, mesh=jmesh8, **kw)
    for a, b, c, w in zip(single, sharded, three, want):
        assert np.array_equal(a, b)
        assert np.array_equal(a, c)
        assert np.array_equal(b, w)


@pytest.mark.parametrize("engine", ["full-nw", "shift-banded"])
def test_polisher_on_a_mesh(engine, monkeypatch):
    """Polisher.MESH forces the mesh votes (raven_tpu's
    RAVEN_TPU_SHARDED_POLISH=1): every consensus call of a polish takes
    the mesh and gives what the same call gives on one device, so the
    contigs are the same."""
    from raven_tpu_torch.config import DeviceCfg
    from raven_tpu_torch.io.readset import encode
    from raven_tpu_torch.ops import consensus_band, consensus_device
    from raven_tpu_torch.polish.polisher import Polisher

    rng = np.random.default_rng(4242)
    genome = random_genome(rng, 6000)
    reads = sample_reads(rng, genome, 30, 2500, error=0.05)[0]
    truth = encode(genome)
    keep = rng.random(truth.size) >= 0.03
    draft = np.where(rng.random(keep.sum()) < 0.03, (truth[keep] + 1) % 4,
                     truth[keep]).astype(np.uint8)
    mesh = Mesh(["cpu"] * 2)
    calls = []
    mod = consensus_device if engine == "full-nw" else consensus_band
    name = "device_window_consensus" if engine == "full-nw" else "band_window_consensus"
    fn = getattr(mod, name)

    def on_both(windows, **k):
        got = fn(windows, **k)
        calls.append(k["mesh"])
        want = fn(windows, **dict(k, mesh=None))
        assert len(got) == len(want) == len(windows)
        for g, w in zip(got, want):
            assert np.array_equal(g, w)
        return got

    monkeypatch.setattr(mod, name, on_both)
    monkeypatch.setattr(Polisher, "MESH", mesh)
    kw = (dict(device_cfg=DeviceCfg(poa_batches=1)) if engine == "full-nw"
          else dict(use_device=True))
    p = Polisher(device="cpu", **kw)
    out = p.polish([("Ctg0", draft)], TReadSet.from_sequences(reads))
    assert p.last_engine == "device"
    assert calls and all(m is mesh for m in calls)
    assert len(out) == 1 and out[0][0].startswith("Ctg0 XC:f:")
