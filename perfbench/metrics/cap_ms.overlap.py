"""The construct driver's cap a pass (graph/construct.py: each touched
read's list cut to its max_num_overlaps longest), ms: the program's
`construct.cap` spans over its `construct.find_overlaps` spans in the
window."""

from perfbench import program_spans


def read(run):
    return program_spans.ms_per(run, "construct.cap", "construct.find_overlaps")
