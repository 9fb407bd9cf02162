"""The share of K3's and K4's launched rows that hold a fragment, %: the
fragments over the padded rows (B_pad) of the program's `band.prepare`
spans in the window, summed over the groups."""

from perfbench import program_spans


def read(run):
    prep = [r.counts for r in program_spans.in_window(run) if r.name == "band.prepare"]
    rows = sum(c["rows"] for c in prep)
    return 100.0 * sum(c["fragments"] for c in prep) / rows if rows else None
