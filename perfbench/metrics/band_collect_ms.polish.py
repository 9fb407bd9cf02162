"""The shift-banded engine's collection a call (ops/consensus_band.py:
every group's tokens brought to the host, which waits for the card, and
cut into windows), ms: the program's `band.collect` spans over its
`band.call` spans in the window."""

from perfbench import program_spans


def read(run):
    return program_spans.ms_per(run, "band.collect", "band.call")
