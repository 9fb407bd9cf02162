"""Port device chaining (raven_tpu_torch.ops.chain_device) vs the JAX
package's chain_matches_device and the host chain oracle
(raven_tpu.overlap.chain.chain_matches): byte-identical per-read overlap
arrays, emission order included, on the cases of tests/test_chain_device.py.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jnp = jax.numpy

from raven_tpu.ops import chain_device as jcd  # noqa: E402
from raven_tpu.overlap import chain as jchain  # noqa: E402
from raven_tpu_torch.ops import chain_device as tcd  # noqa: E402


def _host_chain(q_id, q_pos, t_id, t_pos, same, k):
    out = {}
    order = np.argsort(q_id, kind="stable")
    q_id, q_pos, t_id, t_pos, same = (
        a[order] for a in (q_id, q_pos, t_id, t_pos, same)
    )
    uniq, starts = np.unique(q_id, return_index=True)
    bounds = np.append(starts, q_id.size)
    for u, s0, s1 in zip(uniq, bounds[:-1], bounds[1:]):
        out[int(u)] = jchain.chain_matches(
            int(u),
            t_id[s0:s1].astype(np.uint32),
            same[s0:s1].astype(np.uint8),
            q_pos[s0:s1].astype(np.int64),
            t_pos[s0:s1].astype(np.int64),
            k,
        )
    return {u: v for u, v in out.items() if v.size}


def _pad(a, pad, fill):
    a = np.asarray(a, np.int64)
    return np.concatenate([a, np.full(pad, fill, np.int64)]) if pad else a


def _jax_chain(m, k, pad=0):
    cols = [
        jnp.asarray(_pad(a, pad, f).astype(np.int32))
        for a, f in zip(m, (-1, 0, 0, 0, 0))
    ]
    return jcd.chain_matches_device(*cols, k)


def _torch_chain(m, k, pad=0):
    cols = [torch.from_numpy(_pad(a, pad, f)) for a, f in zip(m, (-1, 0, 0, 0, 0))]
    return tcd.chain_matches_device(*cols, k)


def _assert_identical(got, want):
    assert set(got) == set(want)
    for u in want:
        assert got[u].dtype == want[u].dtype
        assert got[u].tobytes() == want[u].tobytes(), f"read {u}"


def _synthetic_matches(rng, n, n_reads=12, n_targets=12):
    q_id = rng.integers(0, n_reads, n).astype(np.int64)
    t_id = rng.integers(n_reads, n_reads + n_targets, n).astype(np.int64)
    same = rng.integers(0, 2, n).astype(np.int64)
    q_pos = rng.integers(0, 30000, n).astype(np.int64)
    off = rng.integers(-180, 180, n)
    t_pos = np.where(same.astype(bool), q_pos + 4000 + off, 35000 - q_pos + off)
    t_pos = np.maximum(t_pos, 0).astype(np.int64)
    return q_id, q_pos, t_id, t_pos, same


def _gap_split_case():
    qpos = [a * 40 for a in range(6)] + [a * 40 + 20000 for a in range(6)]
    tpos = [5000 + a * 40 for a in range(6)] + [25000 + a * 40 for a in range(6)]
    n = len(qpos)
    return (
        np.zeros(n, np.int64), np.array(qpos, np.int64), np.ones(n, np.int64),
        np.array(tpos, np.int64), np.ones(n, np.int64),
    )


def _monster_case():
    n = tcd.BUCKETS[-1] + 8
    cols = (
        [0] * n + [3] * 8,
        [a * 20 for a in range(n)] + [a * 40 for a in range(8)],
        [1] * n + [4] * 8,
        [a * 20 + 5000 for a in range(n)] + [a * 40 + 900 for a in range(8)],
        [1] * (n + 8),
    )
    return tuple(np.array(c, np.int64) for c in cols)


CASES = {
    "random1": lambda: _synthetic_matches(np.random.default_rng(1), 20000),
    "random2": lambda: _synthetic_matches(np.random.default_rng(2), 20000),
    "random3": lambda: _synthetic_matches(np.random.default_rng(3), 20000),
    "gap_split": _gap_split_case,
    "monster_group": _monster_case,
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_chain_matches_jax_and_host(case):
    m = CASES[case]()
    got = _torch_chain(m, 15)
    _assert_identical(got, _jax_chain(m, 15))
    _assert_identical(got, _host_chain(*m, 15))
    if case == "gap_split":
        assert got[0].size == 2


def test_chain_sentinel_padding():
    """Padded rows (q_id < 0) must not affect the emitted overlaps."""
    m = _synthetic_matches(np.random.default_rng(7), 6000)
    _assert_identical(_torch_chain(m, 15, pad=517), _host_chain(*m, 15))


def test_lis_keep_matches_jax():
    """The batched patience LIS keeps exactly the JAX scan's anchors."""
    rng = np.random.default_rng(9)
    n_g, G = 40, 32
    vals = rng.integers(-500, 500, (n_g, G)).astype(np.int32)
    size = rng.integers(1, G + 1, n_g).astype(np.int32)
    want = np.asarray(jcd._lis_keep(jnp.asarray(vals), jnp.asarray(size), G))
    got = tcd._lis_keep(
        torch.from_numpy(vals).to(torch.int64), torch.from_numpy(size).to(torch.int64), G
    ).numpy()
    assert np.array_equal(got & (np.arange(G)[None] < size[:, None]), want)
