"""raven_tpu_torch stands alone: every module imports with jax blocked and
loads nothing of raven_tpu; the default device is CUDA and raises without
it; polishing (-p above 0) exits with status 2 instead of being skipped."""

import os
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_IMPORT_ALL = """
import importlib, pkgutil, sys
sys.modules["jax"] = None  # any import of jax fails
import raven_tpu_torch
names = [
    m.name
    for m in pkgutil.walk_packages(raven_tpu_torch.__path__, "raven_tpu_torch.")
    if not m.name.endswith("__main__")
]
for name in names:
    importlib.import_module(name)
leaked = sorted(
    k for k in sys.modules if k == "raven_tpu" or k.startswith("raven_tpu.")
)
print(len(names), leaked)
"""


def _run(args, **kw):
    env = dict(os.environ, PYTHONPATH=REPO)
    return subprocess.run(
        [sys.executable, *args], cwd=REPO, env=env, capture_output=True,
        text=True, timeout=300, **kw,
    )


def test_imports_without_jax_or_raven_tpu():
    r = _run(["-c", _IMPORT_ALL])
    assert r.returncode == 0, r.stderr
    count, leaked = r.stdout.strip().split(" ", 1)
    assert int(count) >= 30
    assert leaked == "[]"


def test_default_device_is_cuda_and_raises_without_it(monkeypatch):
    from raven_tpu_torch.device import resolve_device
    from raven_tpu_torch.overlap.engine import MinimizerIndex

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        MinimizerIndex(15, 5)
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        resolve_device("mps")


def test_polishing_exits_with_status_2(tmp_path, capsys):
    from raven_tpu_torch import cli

    reads = tmp_path / "reads.fa"
    reads.write_text(">r0\nACGTACGTACGT\n")
    assert cli.main([str(reads), "-p", "1", "--device", "cpu"]) == 2
    assert "later slice" in capsys.readouterr().err
    # the default -p is 2, as in the reference, and is refused the same way
    r = _run(["-m", "raven_tpu_torch", str(reads), "--device", "cpu"])
    assert r.returncode == 2
    assert "later slice" in r.stderr
    assert r.stdout == ""
