"""The shift-banded engine's uploads a call (ops/consensus_band.py:
_upload, each group's six arrays pinned and copied to the card without
blocking), ms: the program's `band.upload` spans summed over its
`band.call` spans in the window."""

from perfbench import program_spans


def read(run):
    return program_spans.ms_per(run, "band.upload", "band.call")
