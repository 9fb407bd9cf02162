"""Struct-of-arrays read storage (the biosoup::NucleicAcid equivalent).

Instead of one heap object per read (reference biosoup, see use sites at
RavenLib/src/construct.cc:177-187), reads live in flat numpy arrays so whole
batches can be shipped to the device: a single `codes` array of 2-bit base
codes (stored one byte per base on the host; densified/padded on demand for
device kernels), plus offsets/lengths, and optional per-base quality.

Base coding matches biosoup: A=0, C=1, G=2, T=3; complement is `code ^ 3`.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Sequence

import numpy as np

# ASCII -> 2-bit code lookup (255 = unknown, mapped like biosoup's coder:
# unknown IUPAC letters fall back deterministically; we map N and friends
# the same way biosoup does for ACGT-adjacent codes where defined, else A).
_CODER = np.full(256, 255, dtype=np.uint8)
for _ch, _code in (
    ("A", 0), ("a", 0),
    ("C", 1), ("c", 1),
    ("G", 2), ("g", 2),
    ("T", 3), ("t", 3), ("U", 3), ("u", 3),
    # common ambiguity codes -> deterministic fallback (biosoup kNucleotideCoder
    # maps R->0, Y->1, K->2, M->0, S->1, W->0, B->1, D->0, H->0, V->0, N->0)
    ("R", 0), ("r", 0), ("Y", 1), ("y", 1), ("K", 2), ("k", 2),
    ("M", 0), ("m", 0), ("S", 1), ("s", 1), ("W", 0), ("w", 0),
    ("B", 1), ("b", 1), ("D", 0), ("d", 0), ("H", 0), ("h", 0),
    ("V", 0), ("v", 0), ("N", 0), ("n", 0),
):
    _CODER[ord(_ch)] = _code

_DECODER = np.frombuffer(b"ACGT", dtype=np.uint8)


def encode(seq: str | bytes) -> np.ndarray:
    """ASCII sequence -> uint8 array of 2-bit codes."""
    if isinstance(seq, str):
        seq = seq.encode("ascii")
    raw = np.frombuffer(seq, dtype=np.uint8)
    codes = _CODER[raw]
    if (codes == 255).any():
        bad = raw[codes == 255][0]
        raise ValueError(f"invalid nucleotide character {chr(bad)!r}")
    return codes


def decode(codes: np.ndarray) -> str:
    """uint8 code array -> ASCII string."""
    return _DECODER[codes].tobytes().decode("ascii")


def reverse_complement(codes: np.ndarray) -> np.ndarray:
    return (codes[::-1] ^ 3).astype(np.uint8)


@dataclasses.dataclass
class ReadSet:
    """A set of reads as struct-of-arrays.

    names:   per-read name (python list, host only)
    starts:  int64[N] offset of each read in `codes` (and `quals`)
    lengths: int64[N]
    codes:   uint8[total] 2-bit base codes
    quals:   uint8[total] phred qualities (empty array if FASTA input)
    """

    names: list[str]
    starts: np.ndarray
    lengths: np.ndarray
    codes: np.ndarray
    quals: np.ndarray

    def __len__(self) -> int:
        return len(self.names)

    @property
    def has_quality(self) -> bool:
        return self.quals.size > 0

    def sequence(self, i: int, begin: int = 0, length: int | None = None) -> np.ndarray:
        """Code slice of read i, biosoup InflateData(i=begin, len) analog."""
        s = int(self.starts[i])
        n = int(self.lengths[i])
        if length is None:
            length = n - begin
        length = max(0, min(length, n - begin))
        return self.codes[s + begin : s + begin + length]

    def sequence_str(self, i: int, begin: int = 0, length: int | None = None) -> str:
        return decode(self.sequence(i, begin, length))

    def quality(self, i: int, begin: int = 0, length: int | None = None) -> np.ndarray:
        if not self.has_quality:
            return np.empty(0, dtype=np.uint8)
        s = int(self.starts[i])
        n = int(self.lengths[i])
        if length is None:
            length = n - begin
        length = max(0, min(length, n - begin))
        return self.quals[s + begin : s + begin + length]

    def mean_quality(self, i: int) -> float:
        q = self.quality(i)
        return float(q.mean()) if q.size else 0.0

    def drop_quality(self) -> None:
        """Forget qualities (reference polish.cc:35-38 when all are '!')."""
        self.quals = np.empty(0, dtype=np.uint8)

    @staticmethod
    def from_sequences(
        seqs: Sequence[str | bytes | np.ndarray],
        names: Iterable[str] | None = None,
        quals: Sequence[np.ndarray | bytes | None] | None = None,
    ) -> "ReadSet":
        code_parts: list[np.ndarray] = []
        for s in seqs:
            code_parts.append(
                s.astype(np.uint8) if isinstance(s, np.ndarray) else encode(s)
            )
        lengths = np.array([p.size for p in code_parts], dtype=np.int64)
        starts = np.zeros(len(code_parts), dtype=np.int64)
        if len(code_parts):
            np.cumsum(lengths[:-1], out=starts[1:])
        codes = (
            np.concatenate(code_parts) if code_parts else np.empty(0, dtype=np.uint8)
        )
        if names is None:
            names_list = [f"read_{i}" for i in range(len(code_parts))]
        else:
            names_list = list(names)
        if quals is not None and any(q is not None for q in quals):
            q_parts = []
            for q, n in zip(quals, lengths):
                if q is None:
                    q_parts.append(np.zeros(int(n), dtype=np.uint8))
                elif isinstance(q, bytes):
                    q_parts.append(np.frombuffer(q, dtype=np.uint8) - 33)
                else:
                    q_parts.append(q.astype(np.uint8))
            qarr = np.concatenate(q_parts) if q_parts else np.empty(0, dtype=np.uint8)
        else:
            qarr = np.empty(0, dtype=np.uint8)
        return ReadSet(names_list, starts, lengths, codes, qarr)

    def padded_batch(
        self, ids: np.ndarray | None = None, pad_to: int | None = None, multiple: int = 128
    ) -> tuple[np.ndarray, np.ndarray]:
        """Dense [B, L] uint8 batch (padded with 0) + int32 lengths.

        Device kernels want rectangular arrays; L is rounded up to `multiple`
        for device lane alignment.
        """
        if ids is None:
            ids = np.arange(len(self), dtype=np.int64)
        lens = self.lengths[ids].astype(np.int64)
        max_len = int(lens.max()) if lens.size else 0
        if pad_to is not None:
            max_len = max(max_len, pad_to)
        max_len = ((max_len + multiple - 1) // multiple) * multiple if max_len else multiple
        out = np.zeros((len(ids), max_len), dtype=np.uint8)
        for row, i in enumerate(ids):
            s = int(self.starts[i])
            n = int(self.lengths[i])
            out[row, :n] = self.codes[s : s + n]
        return out, lens.astype(np.int32)
