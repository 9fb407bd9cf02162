"""FASTA/FASTQ(.gz) parsing into a ReadSet.

Extension-sniffing factory with the same accepted extensions and error
behaviour as the reference (RavenLib/src/io.cc:7-41); parsing itself is a
from-scratch streaming implementation (the reference delegates to the
`bioparser` dependency).  A C++ fast path lives in raven_tpu_torch.native and is
used automatically when available.
"""

from __future__ import annotations

import gzip
import io
import os
from typing import Iterator

import numpy as np

from raven_tpu_torch.io.readset import ReadSet, encode

FASTA_EXT = (".fasta", ".fa", ".fasta.gz", ".fa.gz")
FASTQ_EXT = (".fastq", ".fq", ".fastq.gz", ".fq.gz")


class ParserError(ValueError):
    pass


def _open(path: str) -> io.BufferedReader:
    if path.endswith(".gz"):
        return gzip.open(path, "rb")  # type: ignore[return-value]
    return open(path, "rb")


def _iter_fasta(fh) -> Iterator[tuple[str, bytes, None]]:
    name = None
    chunks: list[bytes] = []
    for raw in fh:
        line = raw.rstrip()
        if not line:
            continue
        if line.startswith(b">"):
            if name is not None:
                if not chunks:
                    raise ParserError(f"empty sequence for {name}")
                yield name, b"".join(chunks), None
            # name = first whitespace-delimited token after '>'
            name = line[1:].split()[0].decode("ascii") if len(line) > 1 else ""
            chunks = []
        else:
            if name is None:
                raise ParserError("FASTA data before first header")
            chunks.append(line)
    if name is not None:
        if not chunks:
            raise ParserError(f"empty sequence for {name}")
        yield name, b"".join(chunks), None


def _iter_fastq(fh) -> Iterator[tuple[str, bytes, bytes]]:
    while True:
        header = fh.readline()
        if not header:
            return
        header = header.rstrip()
        if not header:
            continue
        if not header.startswith(b"@"):
            raise ParserError("malformed FASTQ header")
        name = header[1:].split()[0].decode("ascii") if len(header) > 1 else ""
        seq = fh.readline().rstrip()
        plus = fh.readline()
        if not plus.startswith(b"+"):
            raise ParserError("malformed FASTQ separator")
        qual = fh.readline().rstrip()
        if len(qual) != len(seq):
            raise ParserError("FASTQ quality length mismatch")
        yield name, seq, qual


def parse_file(path: str) -> ReadSet:
    """Parse one FASTA/FASTQ file (optionally gzipped) into a ReadSet.

    Raises ParserError for unsupported extensions, mirroring the error text
    behaviour of reference io.cc:35-40.
    """
    base = os.path.basename(path)
    if base.endswith(FASTA_EXT):
        is_fastq = False
    elif base.endswith(FASTQ_EXT):
        is_fastq = True
    else:
        raise ParserError(
            f"file {path} has unsupported format extension (valid extensions:"
            " .fasta, .fasta.gz, .fa, .fa.gz, .fastq, .fastq.gz, .fq, .fq.gz)"
        )

    try:
        from raven_tpu_torch.native import fastx_native

        result = fastx_native.parse(path, is_fastq)
        if result is not None:
            return result
    except Exception:
        pass  # fall back to the pure-python parser

    names: list[str] = []
    code_parts: list[np.ndarray] = []
    qual_parts: list[np.ndarray] = []
    with _open(path) as fh:
        it = _iter_fastq(fh) if is_fastq else _iter_fasta(fh)
        for name, seq, qual in it:
            names.append(name)
            code_parts.append(encode(seq))
            if is_fastq:
                qual_parts.append(np.frombuffer(qual, dtype=np.uint8) - 33)

    lengths = np.array([p.size for p in code_parts], dtype=np.int64)
    starts = np.zeros(len(code_parts), dtype=np.int64)
    if len(code_parts):
        np.cumsum(lengths[:-1], out=starts[1:])
    codes = np.concatenate(code_parts) if code_parts else np.empty(0, dtype=np.uint8)
    if is_fastq and qual_parts:
        quals = np.concatenate(qual_parts)
        if not quals.any():  # all '!' -> treat as no quality (polish.cc:35-38)
            quals = np.empty(0, dtype=np.uint8)
    else:
        quals = np.empty(0, dtype=np.uint8)
    return ReadSet(names, starts, lengths, codes, quals)


def load_sequences(paths: list[str]) -> ReadSet:
    """Parse and concatenate several files (reference main.cc:258-299 /
    ravenpy.cc LoadSequences), assigning sequential global ids."""
    sets = []
    for p in paths:
        rs = parse_file(p)
        if len(rs) == 0:
            import sys

            print(f"[raven_tpu::] warning: file {p} is empty", file=sys.stderr)
            continue
        sets.append(rs)
    if not sets:
        return ReadSet([], np.empty(0, np.int64), np.empty(0, np.int64),
                       np.empty(0, np.uint8), np.empty(0, np.uint8))
    if len(sets) == 1:
        return sets[0]
    names: list[str] = []
    for rs in sets:
        names.extend(rs.names)
    lengths = np.concatenate([rs.lengths for rs in sets])
    codes = np.concatenate([rs.codes for rs in sets])
    has_q = any(rs.has_quality for rs in sets)
    if has_q:
        quals = np.concatenate(
            [
                rs.quals if rs.has_quality else np.zeros(rs.codes.size, np.uint8)
                for rs in sets
            ]
        )
    else:
        quals = np.empty(0, dtype=np.uint8)
    starts = np.zeros(len(names), dtype=np.int64)
    np.cumsum(lengths[:-1], out=starts[1:])
    return ReadSet(names, starts, lengths, codes, quals)
