"""Sequence input readers (counterpart of slacken_tpu/inputs.py).

Streaming FASTA/FASTQ parsing with gzip/bzip2 support, `@file` list
expansion, paired-end joining, the genome library, and the native-packed
fast paths for classification input (native.PackedReads chunks).
"""

from __future__ import annotations

import bz2
import gzip
import os
import re
from typing import Iterable, Iterator, List, Optional, Tuple

import numpy as np

from . import native
from .classify import Fragment
from .ops import encode
from .zio import open_gz_subprocess

DEFAULT_MAX_FRAGMENT = 1 << 20


def open_maybe_compressed(path: str, mode: str = "rt"):
    if path.endswith(".gz"):
        if mode in ("rb", "r"):
            # inflate in a gzip child process so the parse/pack thread
            # keeps its whole core
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


def is_fasta(path: str) -> bool:
    base = re.sub(r"\.(gz|bz2)$", "", path)
    return base.endswith((".fasta", ".fa", ".fna", ".ffn", ".faa", ".frn"))


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


def read_fastq(path: str) -> Iterator[Tuple[str, str]]:
    """Yield (header, sequence) from FASTQ, validating record structure."""
    with open_maybe_compressed(path) as f:
        while True:
            h = f.readline()
            if not h:
                return
            s = f.readline()
            plus = f.readline()
            q = f.readline()
            if not q:
                raise ValueError(f"{path}: truncated FASTQ record at {h!r}")
            if not h.startswith("@") or not plus.startswith("+"):
                raise ValueError(f"{path}: malformed FASTQ record at {h!r}")
            yield h[1:].rstrip("\n\r"), s.strip()


def read_sequences(path: str) -> Iterator[Tuple[str, str]]:
    if is_fastq(path):
        return read_fastq(path)
    return read_fasta(path)


def _strip_pair_suffix(title: str) -> str:
    """Strip /1, /2 mate suffixes from the id token."""
    tok = title.split()[0] if title else title
    return re.sub(r"/[12]$", "", tok)


def read_pairs(
    path1: str, path2: str, max_pending: int = 1 << 20
) -> Iterator[Tuple[str, str, str]]:
    """Yield (header, seq1, seq2) joining two mate files. Reads are matched
    by position with header verification, falling back to a join by header
    when the files disagree in order. The out-of-order buffer is bounded:
    mate files whose orders diverge by more than `max_pending` reads raise
    instead of buffering a whole file in memory."""
    it2 = read_sequences(path2)
    pending2 = {}
    for h1, s1 in read_sequences(path1):
        key = _strip_pair_suffix(h1)
        if key in pending2:
            yield h1, s1, pending2.pop(key)
            continue
        for h2, s2 in it2:
            if _strip_pair_suffix(h2) == key:
                yield h1, s1, s2
                break
            pending2[_strip_pair_suffix(h2)] = s2
            if len(pending2) > max_pending:
                raise ValueError(
                    f"mate files {path1!r} and {path2!r} diverge in read order "
                    f"by more than {max_pending} reads; sort them consistently "
                    "or raise max_pending"
                )


def fragments_from_files(
    files: List[str], paired: bool = False, max_fragment: Optional[int] = None, k: int = 35
) -> Iterator[Fragment]:
    """Fragments for classification. With paired=True, consecutive files are
    mate pairs."""
    files = expand_file_list(files)
    if paired:
        if len(files) % 2 != 0:
            raise ValueError("paired mode requires an even number of input files")
        for f1, f2 in zip(files[0::2], files[1::2]):
            for h, s1, s2 in read_pairs(f1, f2):
                yield Fragment(h, s1, s2)
    else:
        for path in files:
            for h, s in read_sequences(path):
                if max_fragment and len(s) > max_fragment:
                    step = max_fragment - (k - 1)
                    for i, off in enumerate(range(0, len(s) - k + 1, step)):
                        yield Fragment(h if i == 0 else f"{h} (part {i})", s[off : off + max_fragment])
                else:
                    yield Fragment(h, s)


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


class MatesOutOfOrder(ValueError):
    """Two mate files do not list their reads in the same order."""


def packed_pairs_from_files(path1: str, path2: str, chunk_bytes: int = 64 << 20):
    """Stream paired FASTQ files as native-packed paired rows. Mates are
    matched positionally (the near-universal layout); a header check guards
    the pairing and raises MatesOutOfOrder (a ValueError) on a mismatch, so
    the caller can fall back to the id-joining reader."""
    gen1 = packed_reads_from_file(path1, chunk_bytes)
    gen2 = packed_reads_from_file(path2, chunk_bytes)
    buf1 = buf2 = None
    while True:
        if buf1 is None or len(buf1) == 0:
            buf1 = next(gen1, None)
        if buf2 is None or len(buf2) == 0:
            buf2 = next(gen2, None)
        if buf1 is None or buf2 is None:
            break
        n = min(len(buf1), len(buf2))
        head1 = _strip_pair_suffix(buf1.titles[0])
        head2 = _strip_pair_suffix(buf2.titles[0])
        if head1 != head2:
            raise MatesOutOfOrder(
                f"paired files disagree in record order ({head1!r} vs {head2!r}); "
                "use fragments_from_files(paired=True) for id-joined pairing"
            )
        p1 = native.PackedReads(buf1.codes[:n], buf1.lengths[:n], buf1.titles[:n])
        p2 = native.PackedReads(buf2.codes[:n], buf2.lengths[:n], buf2.titles[:n])
        yield native.pack_pairs(p1, p2)
        buf1 = native.PackedReads(buf1.codes[n:], buf1.lengths[n:], buf1.titles[n:])
        buf2 = native.PackedReads(buf2.codes[n:], buf2.lengths[n:], buf2.titles[n:])


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


def has_fai(path: str) -> bool:
    return os.path.exists(path + ".fai")


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
            if has_fai(path) and not path.endswith((".gz", ".bz2")):
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

    def taxon_set(self, taxonomy) -> set:
        """All label taxa (canonicalised) closed upward to root
        (GenomeLibrary.scala:35-44)."""
        base = set()
        for t in self.labels.values():
            if t < len(taxonomy.primary):
                base.add(int(taxonomy.primary[t]))
        return taxonomy.taxa_with_ancestors([t for t in base if taxonomy.is_defined(t)])

    def input_stats(self, taxonomy) -> dict:
        """Label-file statistics (GenomeLibrary.scala:81-107)."""
        total = len(self.labels)
        distinct = set(self.labels.values())
        defined = {t for t in distinct if t < taxonomy.size and taxonomy.is_defined(t)}
        return {
            "sequences": total,
            "distinct_taxa": len(distinct),
            "defined_taxa": len(defined),
            "undefined_taxa": len(distinct - defined),
        }


def check_input(library: GenomeLibrary, k: int) -> List[str]:
    """Report sequences that would produce no minimizers, those with no
    valid run of at least k bases (KeyValueIndex.checkInput,
    KeyValueIndex.scala:56-76)."""
    bad = []
    for _, header, seq in library.sequences():
        codes = encode.encode_seq(seq)
        valid = codes < encode.INVALID
        if len(valid) < k:
            bad.append(header)
            continue
        # longest valid run via cumulative reset counting
        idx = np.arange(len(valid))
        last_reset = np.maximum.accumulate(np.where(~valid, idx, -1))
        if int((idx - last_reset).max()) < k:
            bad.append(header)
    if bad:
        print(f"Some input sequences had no minimizers (total {len(bad)}):")
        for h in bad[:20]:
            print(f"  {h}")
    else:
        print("Input sequences checked, all had minimizers.")
    return bad
