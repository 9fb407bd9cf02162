"""The shift-banded engine's switch cases of tests/test_torch_switches.py
and tests/test_torch_switches_cli.py: Polisher.CONSENSUS_ENGINE =
"shiftband" with --device-poa-batches 8 (the shift-banded engine in every
round) through the Polisher and through both CLIs, and the shift-banded
engine under Polisher.MESH = False, against raven_tpu with its variables
set.  The longest of those files' cases, in a file of their own so that
the suite's workers run them apart (pytest-xdist's --dist loadfile hands
out a file whole, files with more tests first)."""

import pytest

jax = pytest.importorskip("jax")

from tests.test_torch_polish import reads_path, setup  # noqa: E402, F401
from tests.torch_switches_common import (  # noqa: E402, F401
    SHIFTBAND, _one_torch_thread, _reference_env, check_cli_route,
    check_mesh_refused_polisher, check_polisher_route,
)


@pytest.mark.parametrize("route", [SHIFTBAND])
def test_polisher_consensus_switches_match_jax(setup, route, monkeypatch):  # noqa: F811
    check_polisher_route(setup, route, monkeypatch)


@pytest.mark.parametrize("batches", [0], ids=["shiftband"])
def test_mesh_refused_polisher_matches_jax(setup, batches, monkeypatch):  # noqa: F811
    check_mesh_refused_polisher(setup, batches, monkeypatch)


@pytest.mark.parametrize("route", [SHIFTBAND])
def test_cli_consensus_switches_match_jax(reads_path, route, monkeypatch, capsys):  # noqa: F811
    """`-p 2 --device-poa-batches 8` with the shift-banded engine on both
    CLIs: the same contig FASTA, the shift-banded consensus in both
    rounds."""
    check_cli_route(reads_path, route, monkeypatch, capsys)
