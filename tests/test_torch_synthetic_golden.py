"""The port's end-to-end quality gate: tests/test_synthetic_golden.py through
raven_tpu_torch on the CPU.  A truth-known 400 kb genome read at 40x with
substitutions and indels must assemble and polish into one contig of more
than 0.97 of the genome at an edit-distance rate of 0.05% or less, through
the port's construct_graph, assemble and polish (device="cpu"), with the
simulator and the anchored-ED metric of raven_tpu_torch.utils.synth (copies
of misc/reference_compare.py's).

Marked synthetic_e2e (deselected by default, run next to the JAX package's
gate)."""

import os

import numpy as np
import pytest

pytestmark = pytest.mark.synthetic_e2e

ED_RATE_CEILING = 0.0005  # tests/test_synthetic_golden.py


@pytest.fixture
def all_cores():
    """The run's host pools on every core: GLOBALS.num_threads, which a CLI
    run earlier in the process may have left at 1, is set for this test and
    restored after it."""
    from raven_tpu_torch.config import GLOBALS

    saved = GLOBALS.num_threads
    GLOBALS.num_threads = os.cpu_count()
    yield
    GLOBALS.num_threads = saved


def test_synthetic_polished_quality(all_cores):
    from raven_tpu_torch.config import OverlapPhaseCfg, PolishCfg
    from raven_tpu_torch.graph import Graph, assemble, construct_graph
    from raven_tpu_torch.graph.common import get_unitigs
    from raven_tpu_torch.io.readset import ReadSet
    from raven_tpu_torch.polish import polish
    from raven_tpu_torch.utils.synth import contig_ed, simulate_reads

    rng = np.random.default_rng(77)
    genome = rng.integers(0, 4, 400_000).astype(np.uint8)
    reads = simulate_reads(rng, genome, 40, 9000, 0.025, 0.0125, 0.0125)
    rs = ReadSet.from_sequences(reads)

    graph = Graph()
    construct_graph(graph, rs, OverlapPhaseCfg(use_minhash=True), device="cpu")
    assemble(graph, device="cpu")
    polish(graph, rs, PolishCfg(num_rounds=2), device="cpu")
    unitigs = get_unitigs(graph, drop_unpolished=True)
    assert len(unitigs) == 1, f"expected 1 contig, got {len(unitigs)}"
    codes = unitigs[0].codes
    # linear genome: the contig covers all but the low-coverage ends
    assert codes.size > 0.97 * genome.size
    best, _ = contig_ed(codes, genome)
    rate = best / codes.size
    print(f"synthetic 400kb: contig {codes.size}, ED {best}, rate {rate * 100:.4f}%")
    assert rate <= ED_RATE_CEILING, (best, codes.size, rate)
