"""tests/test_torch_switches.py's consensus routes through both CLIs:
Polisher.CONSENSUS_ENGINE / CONSENSUS_ITERS against raven_tpu run with
RAVEN_TPU_CONSENSUS_ENGINE / RAVEN_TPU_CONSENSUS_ITERS set, `-p 2` on
tests/test_torch_polish.py's 30 kb reads, the same contig FASTA.  A file of
its own, so that the suite's workers run it beside the Polisher's."""

import pytest

jax = pytest.importorskip("jax")

from raven_tpu.polish.polisher import Polisher as JPolisher  # noqa: E402
from raven_tpu_torch.polish.polisher import Polisher as TPolisher  # noqa: E402
from tests.test_torch_polish import _run_both_clis, reads_path  # noqa: E402, F401
from tests.test_torch_switches import (  # noqa: E402, F401
    ROUTES,
    _one_torch_thread,
    _reference_env,
    _route,
)


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



@pytest.mark.parametrize("route", list(ROUTES))
def test_cli_consensus_switches_match_jax(reads_path, route, monkeypatch, capsys):  # noqa: F811
    """`-p 2` (with --device-poa-batches 8 on the shift-banded route) on
    both CLIs: the same contig FASTA, the device consensus in the rounds
    raven_tpu runs it."""
    batches, engines, kw, calls = _route(monkeypatch, route)
    flags = ["-p", "2", "--disable-checkpoints"]
    if batches:
        flags += ["--device-poa-batches", str(batches)]
    else:
        _force_device_consensus(monkeypatch)
    got, want, timings = _run_both_clis(reads_path, flags, monkeypatch, capsys)
    assert got == want
    assert [r["engine"] for r in timings["polish_rounds"]] == engines
    assert len(calls) == engines.count("device")
    assert all({k: c[k] for k in kw} == kw for c in calls)
