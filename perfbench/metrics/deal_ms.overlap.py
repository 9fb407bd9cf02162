"""The construct driver's deal a pass (graph/construct.py: the map's
overlaps concatenated, reversed, sorted and split onto both reads' lists),
ms: the program's `construct.deal` spans over its `construct.find_overlaps`
spans in the window."""

from perfbench import program_spans


def read(run):
    return program_spans.ms_per(run, "construct.deal", "construct.find_overlaps")
