"""Set-up shared by tests/test_torch_switches.py,
tests/test_torch_switches_cli.py and tests/test_torch_switches_shiftband.py:
the routes of raven_tpu's consensus switches, the fixtures that clear
raven_tpu's variables, and each route's check through the Polisher and
through both CLIs."""

import numpy as np
import pytest
import torch

from raven_tpu import config as jconfig
from raven_tpu.io import ReadSet as JReadSet
from raven_tpu.polish.polisher import Polisher as JPolisher
from raven_tpu_torch import config as tconfig
from raven_tpu_torch.io import ReadSet as TReadSet
from raven_tpu_torch.ops import consensus_band as tband
from raven_tpu_torch.ops import consensus_device as tcd
from raven_tpu_torch.overlap.engine import MinimizerIndex as TIndex
from raven_tpu_torch.parallel import mesh as tmesh
from raven_tpu_torch.parallel.sharded_index import ShardedIndex
from raven_tpu_torch.polish.polisher import Polisher as TPolisher
from tests.test_torch_polish import _engines, _run_both_clis

# every switch of raven_tpu these tests set; unset, raven_tpu takes the
# path the port takes by default
_JAX_ENV = (
    "RAVEN_TPU_CONSENSUS_ENGINE", "RAVEN_TPU_CONSENSUS_ITERS",
    "RAVEN_TPU_SHARDED_POLISH", "RAVEN_TPU_SHARDED_MAP", "RAVEN_TPU_BANDED",
    "RAVEN_TPU_PALLAS_CONSENSUS", "RAVEN_TPU_CONSENSUS_GROUP", "RAVEN_TPU_DEVICE_MAP",
    "RAVEN_TPU_DEVICE_CHAIN", "RAVEN_TPU_DEVICE_SKETCH", "RAVEN_TPU_INDEX_PARTS",
)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Several xdist workers share the cores; one torch thread each keeps
    their OpenMP threads from spinning against each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _reference_env(monkeypatch):
    for name in _JAX_ENV:
        monkeypatch.delenv(name, raising=False)


def _calls(monkeypatch, module, name):
    """Record the keyword arguments of every call of module.name."""
    seen = []
    fn = getattr(module, name)

    def spy(*args, **kwargs):
        seen.append(kwargs)
        return fn(*args, **kwargs)

    monkeypatch.setattr(module, name, spy)
    return seen


def _never(monkeypatch, owner, name):
    def boom(*args, **kwargs):
        raise AssertionError(f"{name} must not be called")

    monkeypatch.setattr(owner, name, boom)


def _same_contigs(got, want):
    assert len(got) == len(want) == 1
    for (gn, gc), (wn, wc) in zip(got, want):
        assert gn == wn
        assert gc.dtype == np.uint8
        assert np.array_equal(gc, wc)


# (port attributes, raven_tpu variables, DeviceCfg.poa_batches, the CLI's
# engines by round, the device consensus the port must call and its
# keywords)
ROUTES = {
    "full-without-batches": (
        dict(CONSENSUS_ENGINE="full"), dict(RAVEN_TPU_CONSENSUS_ENGINE="full"), 0,
        ["host", "device"], "device_window_consensus", dict(iterations=4, banded=False),
    ),
    "shiftband-with-8-batches": (
        dict(CONSENSUS_ENGINE="shiftband"), dict(RAVEN_TPU_CONSENSUS_ENGINE="shiftband"), 8,
        ["device", "device"], "band_window_consensus", dict(iterations=4),
    ),
    "iters-2": (
        dict(CONSENSUS_ITERS=2), dict(RAVEN_TPU_CONSENSUS_ITERS="2"), 0,
        ["host", "device"], "band_window_consensus", dict(iterations=2),
    ),
}


def _route(monkeypatch, name):
    attrs, env, batches, engines, fn, kw = ROUTES[name]
    for k, v in attrs.items():
        monkeypatch.setattr(TPolisher, k, v)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    module = tcd if fn == "device_window_consensus" else tband
    return batches, engines, kw, _calls(monkeypatch, module, fn)


SHIFTBAND = "shiftband-with-8-batches"


def check_polisher_route(setup, route, monkeypatch):
    """The Polisher (tests/test_torch_polish.py's 12 kb setup) on both
    packages with `route` set: the same consensus bytes, one device
    consensus call with the route's keywords."""
    reads, draft = setup
    batches, _, kw, calls = _route(monkeypatch, route)
    tkw, jkw = dict(device="cpu"), {}
    if batches:
        tkw["device_cfg"] = tconfig.DeviceCfg(poa_batches=batches)
        jkw["device_cfg"] = jconfig.DeviceCfg(poa_batches=batches)
    else:
        tkw["use_device"] = jkw["use_device"] = True
    tp, jp = TPolisher(**tkw), JPolisher(**jkw)
    got = tp.polish([("Ctg0", draft)], TReadSet.from_sequences(reads))
    want = jp.polish([("Ctg0", draft)], JReadSet.from_sequences(reads))
    _same_contigs(got, want)
    assert tp.last_engine == "device"
    assert len(calls) == 1
    assert {k: calls[0][k] for k in kw} == kw
    if route == "full-without-batches":
        assert "chunk" not in calls[0]  # device_window_consensus's 2,048 rows


def check_mesh_refused_polisher(setup, batches, monkeypatch):
    """With default_mesh giving a virtual mesh of 4 CPU shards,
    Polisher.MESH = False (and MinimizerIndex.MESH = False for its read
    mapping) runs the one-device votes of both engines: no mesh votes, no
    sharded index, raven_tpu's consensus under RAVEN_TPU_SHARDED_POLISH=0."""
    reads, draft = setup
    monkeypatch.setattr(tmesh, "default_mesh", lambda device: tmesh.Mesh(["cpu"] * 4))
    assert tmesh.chosen_mesh(None, torch.device("cpu")).size == 4
    monkeypatch.setattr(TPolisher, "MESH", False)
    monkeypatch.setattr(TIndex, "MESH", False)
    for module in (tcd, tband):
        _never(monkeypatch, module, "local_blocks")
    _never(monkeypatch, ShardedIndex, "build")
    monkeypatch.setenv("RAVEN_TPU_SHARDED_POLISH", "0")
    monkeypatch.setenv("RAVEN_TPU_SHARDED_MAP", "0")
    tkw, jkw = dict(device="cpu"), {}
    if batches:
        tkw["device_cfg"] = tconfig.DeviceCfg(poa_batches=batches)
        jkw["device_cfg"] = jconfig.DeviceCfg(poa_batches=batches)
    else:
        tkw["use_device"] = jkw["use_device"] = True
    tp = TPolisher(**tkw)
    got = tp.polish([("Ctg0", draft)], TReadSet.from_sequences(reads))
    want = JPolisher(**jkw).polish([("Ctg0", draft)], JReadSet.from_sequences(reads))
    _same_contigs(got, want)
    assert tp.last_engine == "device"


def _force_device_consensus(monkeypatch):
    """Both Polishers take the device consensus when it is asked for
    (use_device=True), as on a card or a TPU: on the CPU their drivers
    would take the host POA in every round."""
    for cls in (TPolisher, JPolisher):
        init = cls.__init__

        def wrapped(self, *args, _init=init, **kwargs):
            _init(self, *args, **kwargs)
            self.use_device = True

        monkeypatch.setattr(cls, "__init__", wrapped)


def check_cli_route(reads_path, route, monkeypatch, capsys):
    """`-p 2` (with --device-poa-batches on a route that sets them) on both
    CLIs with `route` set: the same contig FASTA, the device consensus in
    the rounds raven_tpu runs it, with the route's keywords."""
    batches, engines, kw, calls = _route(monkeypatch, route)
    flags = ["-p", "2", "--disable-checkpoints"]
    if batches:
        flags += ["--device-poa-batches", str(batches)]
    else:
        _force_device_consensus(monkeypatch)
    got, want, spans = _run_both_clis(reads_path, flags, monkeypatch, capsys)
    assert got == want
    assert _engines(spans) == engines
    assert len(calls) == engines.count("device")
    assert all({k: c[k] for k in kw} == kw for c in calls)
