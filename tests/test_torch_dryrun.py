"""raven_tpu_torch.dryrun against __graft_entry__.py on the CPU: entry's
consensus step bit-equal to the JAX entry jitted, and dryrun_multichip on
a virtual 8-device CPU mesh, whose pair count is raven_tpu's
sharded_candidate_step's on its 8 virtual devices (tests/conftest.py) and
whose graph is the port's one-device construct's; the command line."""

import importlib.util
import os

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from raven_tpu_torch import dryrun  # noqa: E402
from raven_tpu_torch.parallel.mesh import Mesh  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Several xdist workers share the cores; one torch thread each keeps
    their OpenMP threads from spinning against each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _graft_entry():
    spec = importlib.util.spec_from_file_location(
        "graft_entry_torch", os.path.join(REPO, "__graft_entry__.py")
    )
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_entry_matches_graft_entry():
    """The three vote tables bit for bit, on the same inputs."""
    jfn, jargs = _graft_entry().entry()
    want = jax.jit(jfn)(*jargs)
    fn, args = dryrun.entry("cpu")
    assert len(args) == len(jargs)
    for a, j in zip(args, jargs):
        assert a.dtype == torch.int32 and a.device.type == "cpu"
        assert np.array_equal(a.numpy(), np.asarray(j))
    got = fn(*args)
    assert len(got) == 3
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        assert g.shape == w.shape
        assert np.array_equal(g.numpy(), np.asarray(w))
    assert int(got[0].sum()) > 0 and int(got[2].sum()) > 0


@pytest.fixture(scope="module")
def jmesh8():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 (virtual) devices")
    from raven_tpu.parallel.mesh import make_mesh

    return make_mesh(8)


def test_dryrun_multichip_on_cpu_mesh(jmesh8, capsys):
    """Every check holds with 0 host declines; raven_tpu's pair count on the
    same arrays; the one-device construct's live nodes and graph."""
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from raven_tpu.parallel.sharded_index import sharded_candidate_step
    from raven_tpu_torch.config import OverlapPhaseCfg
    from raven_tpu_torch.graph import Graph, construct_graph
    from raven_tpu_torch.overlap.engine import MinimizerIndex
    from raven_tpu_torch.parallel.worker import graph_digest

    res = dryrun.dryrun_multichip(Mesh(["cpu"] * 8))
    assert res["declines"] == 0 and res["dp_max"] == 0
    assert res["consensus_equal"] and res["band_equal"]
    assert MinimizerIndex.MESH is None
    assert "[raven_tpu_torch::dryrun] 8-device mesh" in capsys.readouterr().out

    inp = dryrun.dryrun_inputs(8)
    axis = jmesh8.axis_names[0]
    shard = NamedSharding(jmesh8, P(axis))
    shard2 = NamedSharding(jmesh8, P(axis, None))
    capacity = ((2 * 512) // 8) * 8
    step = sharded_candidate_step(jmesh8, k=15, w=5, capacity=capacity, occurrence=64)
    want = int(step(jax.device_put(jnp.asarray(inp["codes"]), shard2),
                    jax.device_put(jnp.asarray(inp["lengths"]), shard),
                    jax.device_put(jnp.asarray(inp["read_ids"]), shard)))
    assert res["pairs"] == want > 0

    g = Graph()
    construct_graph(g, inp["readset"], OverlapPhaseCfg(use_minhash=True), device="cpu")
    assert res["live_nodes"] == sum(1 for _ in g.live_nodes()) > 0
    assert res["graph_digest"] == graph_digest(g)


def test_dryrun_without_a_mesh_needs_cards(monkeypatch):
    """A count in place of a mesh means make_mesh over real cards: never a
    repeated device."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(ValueError, match="need 8 CUDA devices"):
        dryrun.dryrun_multichip(8)


def test_dryrun_command_line(capsys):
    """`python -m raven_tpu_torch.dryrun --device cpu`: entry's step, then
    the dry run on Mesh(["cpu"] * 8)."""
    assert dryrun.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "entry: base_votes (8, 128, 5)" in out
    assert "[raven_tpu_torch::dryrun] 8-device mesh" in out
