"""Inputs of the benchmark, made from the seed on the run's device.

Frozen, vectorised copies of the repository's generators:
`make_genome` is chip_smoke.py's (random bases with a planted repeat
family, each copy in a random orientation with its own substitutions),
`simulate_reads` is raven_tpu_torch/utils/synth.py's ONT-like simulator
(lengths normal with a sd of a quarter of the mean, clipped below;
deletions, then substitutions, then insertions after marked bases; either
strand), and `window_bank` builds the window bank of one polishing round
the way `Polisher._fragments` hands it to the consensus engine.  Every
random draw comes from one torch.Generator on the device, in a few large
calls, so a seed gives the same inputs on one kind of device; nothing of
the program is imported here.
"""

from __future__ import annotations

import numpy as np
import torch

# racon's window and the Polisher's shortest fragment (polish/polisher.py)
WINDOW_LEN = 500
MIN_FRAGMENT = 10
# bases mutated in one batch of segments, to hold the device memory down
CHUNK_BASES = 1 << 26


def generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    return g


def mutate(g: torch.Generator, codes, seg, sub: float, ins: float, dele: float):
    """Apply an error profile to concatenated segments: codes uint8 [N],
    seg int64 [N] (each base's segment, ascending).  Returns (codes, seg)
    after deletions, substitutions and insertions (a random base after each
    marked base), segments still contiguous and in order."""
    dev = codes.device
    keep = torch.rand(codes.numel(), generator=g, device=dev) >= dele
    codes, seg = codes[keep], seg[keep]
    n = codes.numel()
    s = torch.rand(n, generator=g, device=dev) < sub
    shift = torch.randint(1, 4, (n,), generator=g, device=dev, dtype=torch.uint8)
    codes = torch.where(s, (codes + shift) % 4, codes)
    marked = torch.rand(n, generator=g, device=dev) < ins
    rep = 1 + marked.to(torch.int64)
    out = codes.repeat_interleave(rep)
    out_seg = seg.repeat_interleave(rep)
    dst = (torch.cumsum(rep, 0) - rep)[marked] + 1
    out[dst] = torch.randint(0, 4, (dst.numel(),), generator=g, device=dev, dtype=torch.uint8)
    return out, out_seg


def _gather_segments(source, starts, lengths):
    """source[starts[i]: starts[i] + lengths[i]] for every i, concatenated,
    with each base's segment index."""
    dev = source.device
    n = lengths.numel()
    seg = torch.repeat_interleave(torch.arange(n, device=dev), lengths)
    first = torch.cumsum(lengths, 0) - lengths
    pos = torch.arange(seg.numel(), device=dev) - first[seg] + starts[seg]
    return source[pos], seg


def sequence_sizes(config: dict) -> list:
    """The configuration's sequence lengths as make_genome builds them:
    `sequences`, the sequence that holds the `tandem` array longer by the
    array's bases."""
    sizes = [int(s) for s in config["sequences"]]
    tandem = config.get("tandem")
    if tandem:
        sizes[int(tandem["sequence"])] += int(tandem["length"]) * int(tandem["copies"])
    return sizes


def make_genome(g: torch.Generator, sizes, repeat: dict | None, device, tandem: dict | None = None):
    """The genome's sequences concatenated (uint8 codes on `device`) and
    their starts.  `repeat` plants `copies` copies of one random element of
    `length` bases, each with `divergence` substitutions and a random
    orientation: spread evenly over the concatenation ("even", chip_smoke's
    rule) or each in a sequence drawn by length at a uniform position
    ("dispersed").  `tandem` then inserts an array of `copies` head-to-tail
    copies of another random element of `length` bases, each with its own
    `divergence` substitutions, into sequence `sequence` at offset `at`
    (sequence_sizes gives the lengths that result)."""
    sizes = [int(s) for s in sizes]
    total = sum(sizes)
    starts = np.concatenate([[0], np.cumsum(sizes)[:-1]]).astype(np.int64)
    genome = torch.randint(0, 4, (total,), generator=g, device=device, dtype=torch.uint8)
    if repeat:
        _plant_repeat(g, genome, sizes, starts, repeat, device)
    if tandem:
        genome, starts = _insert_tandem(g, genome, starts, tandem, device)
    return genome, starts


def _insert_tandem(g: torch.Generator, genome, starts, tandem: dict, device):
    length, copies = int(tandem["length"]), int(tandem["copies"])
    seq, at = int(tandem["sequence"]), int(tandem["at"])
    element = torch.randint(0, 4, (length,), generator=g, device=device, dtype=torch.uint8)
    subs = torch.rand((copies, length), generator=g, device=device) < float(tandem["divergence"])
    shift = torch.randint(1, 4, (copies, length), generator=g, device=device, dtype=torch.uint8)
    array = torch.where(subs, (element[None, :] + shift) % 4, element[None, :]).reshape(-1)
    p = int(starts[seq]) + at
    starts = starts + np.where(np.arange(starts.size) > seq, array.numel(), 0)
    return torch.cat([genome[:p], array, genome[p:]]), starts


def _plant_repeat(g: torch.Generator, genome, sizes, starts, repeat: dict, device):
    total = sum(sizes)
    length, copies, div = int(repeat["length"]), int(repeat["copies"]), float(repeat["divergence"])
    element = torch.randint(0, 4, (length,), generator=g, device=device, dtype=torch.uint8)
    if repeat["placement"] == "even":
        at = np.linspace(total * 0.05, total * 0.95, copies).astype(np.int64)
        at = np.minimum(at, total - length)
    else:
        w = torch.tensor(sizes, dtype=torch.float64, device=device)
        which = torch.multinomial(w, copies, replacement=True, generator=g).cpu().numpy()
        room = np.array(sizes, np.int64)[which] - length
        u = torch.rand(copies, generator=g, device=device, dtype=torch.float64).cpu().numpy()
        at = starts[which] + (u * (room + 1)).astype(np.int64)
    subs = torch.rand((copies, length), generator=g, device=device) < div
    shift = torch.randint(1, 4, (copies, length), generator=g, device=device, dtype=torch.uint8)
    flip = torch.rand(copies, generator=g, device=device) < 0.5
    reps = torch.where(subs, (element[None, :] + shift) % 4, element[None, :])
    reps = torch.where(flip[:, None], reps.flip(1) ^ 3, reps)
    for c in range(copies):
        genome[int(at[c]): int(at[c]) + length] = reps[c]


def read_placements(g: torch.Generator, sizes, depth: float, mean_len: int, sd_frac: float,
                    min_len: int, device):
    """(start, length) of each read in the concatenated genome: as many
    reads as depth x genome / mean length, each from one sequence drawn by
    length, its length normal(mean, sd_frac x mean) clipped to
    [min_len, the sequence], at a uniform start inside the sequence."""
    sizes_t = torch.tensor([int(s) for s in sizes], dtype=torch.int64, device=device)
    total = int(sizes_t.sum())
    n = int(total * depth / mean_len)
    seq_start = torch.cumsum(sizes_t, 0) - sizes_t
    which = torch.multinomial(sizes_t.to(torch.float64), n, replacement=True, generator=g)
    room = sizes_t[which]
    lens = torch.normal(float(mean_len), float(mean_len) * sd_frac, (n,), generator=g,
                        device=device, dtype=torch.float64)
    lens = torch.minimum(lens.clamp(min=min_len).to(torch.int64), room)
    u = torch.rand(n, generator=g, device=device, dtype=torch.float64)
    start = seq_start[which] + (u * (room - lens + 1).to(torch.float64)).to(torch.int64)
    return start, lens


def simulate_reads(g: torch.Generator, genome, sizes, reads: dict):
    """ONT-like reads from `genome` (read_placements, then `mutate` with
    the profile, then the reverse complement of each read drawn to the
    other strand).  Returns (codes uint8, lengths int64) as numpy arrays,
    the reads concatenated in order."""
    dev = genome.device
    start, lens = read_placements(g, sizes, reads["depth"], reads["mean_len"], reads["sd_frac"],
                                  reads["min_len"], dev)
    flip = torch.rand(start.numel(), generator=g, device=dev) < 0.5
    codes_out, lens_out = [], []
    csum = torch.cumsum(lens, 0).cpu().numpy()
    lo = 0
    while lo < start.numel():
        base = csum[lo - 1] if lo else 0
        hi = max(lo + 1, int(np.searchsorted(csum, base + CHUNK_BASES, side="right")))
        src, seg = _gather_segments(genome, start[lo:hi], lens[lo:hi])
        codes, seg = mutate(g, src, seg, reads["sub"], reads["ins"], reads["del"])
        n_seg = torch.bincount(seg, minlength=hi - lo)
        first = torch.cumsum(n_seg, 0) - n_seg
        local = torch.arange(seg.numel(), device=dev) - first[seg]
        rev = flip[lo:hi][seg]
        dst = torch.where(rev, first[seg] + n_seg[seg] - 1 - local, first[seg] + local)
        out = torch.empty_like(codes)
        out[dst] = torch.where(rev, codes ^ 3, codes)
        codes_out.append(out.cpu().numpy())
        lens_out.append(n_seg.cpu().numpy())
        lo = hi
    return np.concatenate(codes_out), np.concatenate(lens_out).astype(np.int64)


def window_bank(g: torch.Generator, genome, sizes, reads: dict, draft: dict,
                window: int = WINDOW_LEN):
    """The window bank of one polishing round over a draft of `genome`'s
    first sequence: windows of `window` truth bases; each window's backbone
    is its truth with the draft's residual error profile; each read
    (read_placements at the reads' depth) that covers part of a window
    gives one fragment, its truth under the window with the reads' error
    profile, oriented to the draft, with its span on the window ([rel,
    rel_end), partial at a read's ends).  Fragments shorter than
    MIN_FRAGMENT are dropped, as the Polisher drops them, and a window
    keeps its fragments in the order of their span starts.  Returns the
    windows as band_window_consensus takes them: [(backbone, fragments,
    None, spans)] of numpy arrays, every window having at least two
    fragments (the Polisher leaves the others unpolished)."""
    dev = genome.device
    G = int(sizes[0])
    n_win = -(-G // window)
    w_start = torch.arange(n_win, device=dev) * window
    w_len = torch.clamp(G - w_start, max=window)
    bb, bb_seg = _gather_segments(genome, w_start, w_len)
    bb, bb_seg = mutate(g, bb, bb_seg, draft["sub"], draft["ins"], draft["del"])
    bb_lens = torch.bincount(bb_seg, minlength=n_win)

    start, lens = read_placements(g, [G], reads["depth"], reads["mean_len"], reads["sd_frac"],
                                  reads["min_len"], dev)
    end = start + lens
    first_w = start // window
    n_frag = (end - 1) // window - first_w + 1
    read_of = torch.repeat_interleave(torch.arange(start.numel(), device=dev), n_frag)
    k = torch.arange(read_of.numel(), device=dev) - (torch.cumsum(n_frag, 0) - n_frag)[read_of]
    win = first_w[read_of] + k
    f_lo = torch.maximum(start[read_of], win * window)
    f_hi = torch.minimum(end[read_of], win * window + window)
    codes, seg = [], []
    csum = torch.cumsum(f_hi - f_lo, 0).cpu().numpy()
    lo = 0
    while lo < win.numel():
        base = csum[lo - 1] if lo else 0
        hi = max(lo + 1, int(np.searchsorted(csum, base + CHUNK_BASES, side="right")))
        src, s = _gather_segments(genome, f_lo[lo:hi], f_hi[lo:hi] - f_lo[lo:hi])
        c, s = mutate(g, src, s + lo, reads["sub"], reads["ins"], reads["del"])
        codes.append(c.cpu().numpy())
        seg.append(s.cpu().numpy())
        lo = hi
    codes = np.concatenate(codes)
    q_lens = np.bincount(np.concatenate(seg), minlength=win.numel())
    q_start = np.concatenate([[0], np.cumsum(q_lens)[:-1]])
    win = win.cpu().numpy()
    rel = (f_lo - torch.as_tensor(win, device=dev) * window).cpu().numpy()
    rel_end = (f_hi - torch.as_tensor(win, device=dev) * window).cpu().numpy()
    keep = q_lens >= MIN_FRAGMENT
    idx = np.flatnonzero(keep)
    idx = idx[np.lexsort((rel[idx], win[idx]))]  # by window, then span start, stable
    bb = bb.cpu().numpy()
    bb_lens = bb_lens.cpu().numpy()
    bb_start = np.concatenate([[0], np.cumsum(bb_lens)[:-1]])
    per_win = np.bincount(win[idx], minlength=n_win)
    bounds = np.concatenate([[0], np.cumsum(per_win)])
    windows = []
    for w in range(n_win):
        f = idx[bounds[w]: bounds[w + 1]]
        if f.size < 2:
            continue
        windows.append((
            bb[bb_start[w]: bb_start[w] + bb_lens[w]],
            [codes[q_start[i]: q_start[i] + q_lens[i]] for i in f.tolist()],
            None,
            list(zip(rel[f].tolist(), rel_end[f].tolist())),
        ))
    return windows
