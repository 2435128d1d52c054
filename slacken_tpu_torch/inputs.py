"""Sequence inputs for the port: copies of slacken_tpu/inputs.py's readers.

slacken_tpu/inputs.py imports slacken_tpu.classify, which imports JAX, and
the GPU host has no JAX; so the functions the port needs are copied here
unchanged (ROADMAP.md records the duplication as debt). The FASTQ/FASTA
packer itself is slacken_tpu.native, which is JAX-free and shared.
"""

from __future__ import annotations

import bz2
import gzip
import os
import re
from typing import Iterable, Iterator, List, Optional, Tuple

from slacken_tpu import native

DEFAULT_MAX_FRAGMENT = 1 << 20


def open_maybe_compressed(path: str, mode: str = "rt"):
    if path.endswith(".gz"):
        if mode in ("rb", "r"):
            from slacken_tpu.zio import open_gz_subprocess

            return open_gz_subprocess(path)
        return gzip.open(path, mode)
    if path.endswith(".bz2"):
        return bz2.open(path, mode)
    return open(path, mode)


def expand_file_list(paths: Iterable[str]) -> List[str]:
    """Expand @list.txt arguments into their contents."""
    out: List[str] = []
    for p in paths:
        if p.startswith("@"):
            with open(p[1:]) as f:
                out.extend(line.strip() for line in f if line.strip())
        else:
            out.append(p)
    return out


def is_fastq(path: str) -> bool:
    base = re.sub(r"\.(gz|bz2)$", "", path)
    return base.endswith((".fastq", ".fq"))


def read_fasta(path: str) -> Iterator[Tuple[str, str]]:
    """Yield (header, sequence); multiline sequences are joined."""
    header = None
    chunks: List[str] = []
    with open_maybe_compressed(path) as f:
        for line in f:
            line = line.rstrip("\n\r")
            if line.startswith(">"):
                if header is not None:
                    yield header, "".join(chunks)
                header = line[1:]
                chunks = []
            elif line:
                chunks.append(line.strip())
        if header is not None:
            yield header, "".join(chunks)


def packed_reads_from_file(path: str, chunk_bytes: int = 64 << 20, row_len: Optional[int] = None):
    """Stream a FASTQ/FASTA file as native-packed code batches
    (native.PackedReads)."""
    if is_fastq(path):
        with open_maybe_compressed(path, "rb") as f:
            tail = b""
            while True:
                chunk = f.read(chunk_bytes)
                if not chunk:
                    break
                buf = tail + chunk
                packed, consumed = native.pack_fastq_chunk(buf, row_len)
                tail = buf[consumed:]
                if len(packed):
                    yield packed
            if tail.strip():
                packed, _ = native.pack_fastq_chunk(
                    tail if tail.endswith(b"\n") else tail + b"\n", row_len
                )
                if len(packed):
                    yield packed
    else:
        with open_maybe_compressed(path, "rb") as f:
            data = f.read()
        packed = native.pack_fasta_chunk(data, row_len)
        if len(packed):
            yield packed


def find_genome_files(location: str, suffix: str = ".fna") -> List[str]:
    """Recursively find genome files under <location>/library."""
    base = os.path.join(location, "library")
    if not os.path.isdir(base):
        base = location
    out = []
    for root, _, names in os.walk(base):
        for n in sorted(names):
            if n.endswith(suffix) or n.endswith(suffix + ".gz"):
                out.append(os.path.join(root, n))
    return sorted(out)


def read_fai(path: str):
    """Parse a samtools .fai index: name -> (length, offset, linebases, linewidth)."""
    out = {}
    with open(path) as f:
        for line in f:
            parts = line.rstrip("\n").split("\t")
            if len(parts) >= 5:
                out[parts[0]] = (int(parts[1]), int(parts[2]), int(parts[3]), int(parts[4]))
    return out


def read_fasta_indexed(path: str, max_chunk: int = DEFAULT_MAX_FRAGMENT, k: int = 35):
    """Stream (header, sequence chunk, offset) from an indexed FASTA in
    chunks overlapping by k-1."""
    fai = read_fai(path + ".fai")
    with open(path, "rb") as f:
        for name, (length, offset, linebases, linewidth) in fai.items():
            start = 0
            while start < max(length - k + 1, 1):
                end = min(start + max_chunk, length)
                fstart = offset + (start // linebases) * linewidth + (start % linebases)
                fend = offset + ((end - 1) // linebases) * linewidth + ((end - 1) % linebases) + 1
                f.seek(fstart)
                raw = f.read(fend - fstart)
                seq = raw.replace(b"\n", b"").replace(b"\r", b"").decode("ascii", "replace")
                yield name, seq, start
                if end >= length:
                    break
                start = end - (k - 1)


class GenomeLibrary:
    """Genome sequences + seqid2taxid.map labels."""

    def __init__(self, files: List[str], label_file: str):
        self.files = files
        self.label_file = label_file
        self._labels: Optional[dict] = None

    @classmethod
    def from_directory(cls, location: str) -> "GenomeLibrary":
        files = find_genome_files(location)
        if not files:
            raise FileNotFoundError(f"No .fna genome files under {location}")
        return cls(files, os.path.join(location, "seqid2taxid.map"))

    @property
    def labels(self) -> dict:
        """seqid (first header token) -> taxon."""
        if self._labels is None:
            m = {}
            with open(self.label_file) as f:
                for line in f:
                    parts = line.rstrip("\n").split("\t")
                    if len(parts) >= 2:
                        m[parts[0]] = int(parts[1])
            self._labels = m
        return self._labels

    def taxon_of(self, header: str) -> Optional[int]:
        return self.labels.get(header.split()[0] if header else header)

    def sequences(self, max_chunk: Optional[int] = None, k: int = 35) -> Iterator[Tuple[int, str, str]]:
        """Yield (taxon, header, sequence) for labelled sequences."""
        for path in self.files:
            if os.path.exists(path + ".fai") and not path.endswith((".gz", ".bz2")):
                for header, seq, _ in read_fasta_indexed(path, max_chunk or DEFAULT_MAX_FRAGMENT, k):
                    taxon = self.labels.get(header)
                    if taxon is not None:
                        yield taxon, header, seq
            else:
                for header, seq in read_fasta(path):
                    taxon = self.taxon_of(header)
                    if taxon is not None:
                        yield taxon, header, seq

    def taxa_sequences(self) -> Iterator[Tuple[int, str]]:
        for taxon, _, seq in self.sequences():
            yield taxon, seq
