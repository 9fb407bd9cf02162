"""tests/test_torch_switches.py's consensus routes through both CLIs:
Polisher.CONSENSUS_ENGINE / CONSENSUS_ITERS against raven_tpu run with
RAVEN_TPU_CONSENSUS_ENGINE / RAVEN_TPU_CONSENSUS_ITERS set, `-p 2` on
tests/test_torch_polish.py's 30 kb reads, the same contig FASTA.  A file of
its own, so that the suite's workers run it beside the Polisher's; the
shift-banded route with 8 batches is in
tests/test_torch_switches_shiftband.py."""

import pytest

jax = pytest.importorskip("jax")

from tests.test_torch_polish import reads_path  # noqa: E402, F401
from tests.torch_switches_common import (  # noqa: E402, F401
    ROUTES, SHIFTBAND, _one_torch_thread, _reference_env, check_cli_route,
)


@pytest.mark.parametrize("route", [r for r in ROUTES if r != SHIFTBAND])
def test_cli_consensus_switches_match_jax(reads_path, route, monkeypatch, capsys):  # noqa: F811
    """`-p 2` on both CLIs: the same contig FASTA, the device consensus in
    the rounds raven_tpu runs it."""
    check_cli_route(reads_path, route, monkeypatch, capsys)
