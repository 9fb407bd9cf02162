"""The construct driver's pile layers a pass (graph/construct.py:
Piles.add_layers over both ends of every overlap), ms: the program's
`construct.layers` spans over its `construct.find_overlaps` spans in the
window."""

from perfbench import program_spans


def read(run):
    return program_spans.ms_per(run, "construct.layers", "construct.find_overlaps")
