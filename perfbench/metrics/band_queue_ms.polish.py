"""The shift-banded engine's launches a call (ops/consensus_band.py:
resident_consensus, each group's refinement loop queued on the card), ms
on the host: the program's `band.queue` spans summed over its
`band.call` spans in the window."""

from perfbench import program_spans


def read(run):
    return program_spans.ms_per(run, "band.queue", "band.call")
