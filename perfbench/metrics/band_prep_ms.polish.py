"""The shift-banded engine's host prep a call (ops/consensus_band.py:
_prepare_group, every group's fragments packed into its band rows), ms:
the program's `band.prepare` spans summed over its `band.call` spans in
the window."""

from perfbench import program_spans


def read(run):
    return program_spans.ms_per(run, "band.prepare", "band.call")
