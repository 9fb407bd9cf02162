"""The device index's foreign join a pass (overlap/device_index.py
foreign_join: the reads of an earlier index batch sketched by K1 and mapped
against a later batch's index, hits expanded and chained), ms: the
program's `index.join_foreign` spans over its `construct.find_overlaps`
spans in the window."""

from perfbench import program_spans


def read(run):
    return program_spans.ms_per(run, "index.join_foreign", "construct.find_overlaps")
