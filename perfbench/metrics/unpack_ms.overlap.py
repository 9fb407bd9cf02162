"""The device chain's unpack a pass (ops/chain_device.py: the chained
overlaps brought to the host and split into per-read arrays), ms: the
program's `index.unpack` spans over its `construct.find_overlaps` spans in
the window."""

from perfbench import program_spans


def read(run):
    return program_spans.ms_per(run, "index.unpack", "construct.find_overlaps")
