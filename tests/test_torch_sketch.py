"""Port sketch (raven_tpu_torch.ops.sketch / sketch_cuda) vs the JAX
package: sketch_plain against sketch_kernel and pallas_sketch in interpret
mode, sketch_segments against sketch_segments_kernel — bit-identical on the
same numpy inputs.  The CUDA kernel itself is held against sketch_plain on
the card by chip_smoke.py."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jnp = jax.numpy

from raven_tpu.io.readset import ReadSet  # noqa: E402
from raven_tpu.ops import sketch as jsk  # noqa: E402
from raven_tpu.ops.pallas_sketch import pallas_sketch  # noqa: E402
from raven_tpu_torch.io.readset import ReadSet as TReadSet  # noqa: E402
from raven_tpu_torch.ops import sketch as tsk  # noqa: E402
from raven_tpu_torch.ops import sketch_cuda  # noqa: E402
from tests.conftest import random_genome, sample_reads  # noqa: E402


def _jax_cols(h, s, kp):
    return (
        np.asarray(h).astype(np.int64),
        np.asarray(s).astype(bool),
        np.asarray(kp).astype(bool),
    )


def _torch_cols(h, s, kp):
    return h.numpy().astype(np.int64), s.numpy(), kp.numpy()


@pytest.mark.parametrize("k,w", [(15, 5), (11, 3)])
@pytest.mark.parametrize("S", [16, 13])
def test_sketch_plain_matches_jax(k, w, S):
    rng = np.random.default_rng(1000 * k + S)
    L = 512
    codes = rng.integers(0, 4, (S, L)).astype(np.uint8)
    lens = rng.integers(0, L + 1, S).astype(np.int32)
    lens[0] = L  # a full row
    lens[1] = k - 1  # no valid k-mer
    want = _jax_cols(*jsk.sketch_kernel(jnp.asarray(codes), jnp.asarray(lens), k, w))
    got = _torch_cols(
        *sketch_cuda.sketch_plain(torch.from_numpy(codes), torch.from_numpy(lens), k, w)
    )
    for a, b in zip(got, want):
        assert np.array_equal(a, b)
    # the interpret-mode TPU kernel (a ragged S pads inside it)
    pal = _jax_cols(
        *pallas_sketch(jnp.asarray(codes), jnp.asarray(lens), k, w, interpret=True)
    )
    for a, b in zip(got, pal):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("k,w", [(15, 5), (12, 4)])
@pytest.mark.parametrize("L", [1000, 2047])
def test_sketch_plain_matches_jax_edge_rows(k, w, L):
    """Widths that are no multiple of 16, lengths below k, a row of one
    repeated base, and rows whose k-mers are their own reverse complements
    (ACGT... has some at an even k, ATAT... has only such): the cases
    K1's strips and 16-byte accesses could break, which chip_smoke.py
    holds the card to."""
    rng = np.random.default_rng(k * L)
    S = 9
    codes = rng.integers(0, 4, (S, L)).astype(np.uint8)
    lens = np.full(S, L, np.int32)
    lens[:4] = [0, k - 1, k, L - 3]
    codes[4] = 2
    codes[5] = np.arange(L) % 4
    codes[6] = (np.arange(L) % 2) * 3
    want = _jax_cols(*jsk.sketch_kernel(jnp.asarray(codes), jnp.asarray(lens), k, w))
    got = _torch_cols(
        *sketch_cuda.sketch_plain(torch.from_numpy(codes), torch.from_numpy(lens), k, w)
    )
    pal = _jax_cols(
        *pallas_sketch(jnp.asarray(codes), jnp.asarray(lens), k, w, interpret=True)
    )
    for a, b, c in zip(got, want, pal):
        assert np.array_equal(a, b)
        assert np.array_equal(a, c)
    assert not got[2][:2].any()  # no k-mer fits a length below k
    if k % 2 == 0:  # every ATAT... k-mer is ambiguous: never kept
        assert not got[2][6].any()


def test_sketch_wrapper_takes_plain_on_cpu():
    rng = np.random.default_rng(5)
    codes = torch.from_numpy(rng.integers(0, 4, (9, 256)).astype(np.uint8))
    lens = torch.full((9,), 256, dtype=torch.int32)
    before = sketch_cuda.LAUNCHES
    a = sketch_cuda.sketch(codes, lens, 15, 5)
    b = sketch_cuda.sketch_plain(codes, lens, 15, 5)
    assert sketch_cuda.LAUNCHES == before  # no kernel on a CPU tensor
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert a[0].dtype == torch.int32 and a[1].dtype == torch.bool


@pytest.mark.parametrize("k,w", [(15, 5), (11, 3)])
def test_sketch_segments_matches_jax(k, w):
    rng = np.random.default_rng(7 + k)
    genome = random_genome(rng, 20000)
    reads, _ = sample_reads(rng, genome, 12, mean_len=3000, error=0.05)
    rs = ReadSet.from_sequences(reads)
    trs = TReadSet.from_sequences(reads)
    ids = np.arange(len(rs))
    width = 512
    jp = jsk.segment_reads_packed(rs, ids, k, w, width=width)
    tp = tsk.segment_reads_packed(trs, ids, k, w, width=width)
    for a, b in zip(jp, tp):
        assert np.array_equal(a, b)
    packed, eff, rid, base, clo, chi = tp
    codes = tsk.unpack_codes(torch.from_numpy(packed))
    got = tsk.sketch_segments(
        codes, *(torch.from_numpy(a) for a in (eff, rid, base, clo, chi)), k, w
    )
    want = jsk.sketch_segments_kernel(
        jnp.asarray(codes.numpy()), *(jnp.asarray(a) for a in (eff, rid, base, clo, chi)), k, w
    )
    for a, b in zip(got, want):
        assert np.array_equal(a.numpy().astype(np.int64), np.asarray(b).astype(np.int64))
