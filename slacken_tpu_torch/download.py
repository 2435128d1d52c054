"""Genome library acquisition (counterpart of slacken_tpu/download.py;
reference: scripts/k2/ — Kraken 2-compatible download tooling:
download_taxonomy.sh, download_genomic_library.sh, download_standard.sh,
rsync_from_ncbi.pl, mask_low_complexity.sh). Host only: no device work.

The reference drives NCBI downloads through a set of bash/perl scripts that
require external binaries (curl, rsync, seqkit, k2mask). Here the same
capability is a Python module: HTTPS via urllib, parallel downloads via a
thread pool, .fai generation natively, and low-complexity masking as a
windowed-entropy filter in numpy (replacing the external k2mask/dustmasker
dependency). The network fetcher is injectable so the pipeline is testable
offline.

Resulting layout matches what GenomeLibrary/`build -l` expects
(Slacken.scala:116-121):

    <db>/library/<name>/*.fna.gz     genomes
    <db>/seqid2taxid.map             sequence id -> taxid labels
    <db>/taxonomy/{nodes,names,merged}.dmp
"""

from __future__ import annotations

import gzip
import io
import os
import tarfile
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, Iterable, List, Optional, Tuple

import numpy as np

NCBI = "https://ftp.ncbi.nlm.nih.gov"

#: libraries download_genomic_library.sh supports (its `case $library_name`)
REFSEQ_LIBRARIES = (
    "archaea",
    "bacteria",
    "viral",
    "fungi",
    "plant",
    "human",
    "protozoa",
)
OTHER_LIBRARIES = ("plasmid", "UniVec", "UniVec_Core")

#: the Kraken 2 "standard" collection (download_standard.sh)
STANDARD_LIBRARIES = ("archaea", "bacteria", "viral", "plasmid", "human", "UniVec_Core")

#: assembly_summary.txt filter levels, most to least complete
#: (the reference's "multiple filter levels" extension of complete/incomplete)
ASSEMBLY_LEVELS = ("Complete Genome", "Chromosome", "Scaffold", "Contig")


def _default_fetcher(url: str) -> bytes:
    with urllib.request.urlopen(url, timeout=600) as r:
        return r.read()


class LibraryDownloader:
    """Build a Kraken 2-style genome library directory from NCBI.

    fetcher: url -> bytes; inject a fake for offline tests. Downloads run
    in `parallel` threads (the reference's parallel-curl extension).
    """

    def __init__(
        self,
        db_dir: str,
        fetcher: Optional[Callable[[str], bytes]] = None,
        parallel: int = 4,
        progress: bool = True,
    ):
        self.db_dir = db_dir
        self.fetch = fetcher or _default_fetcher
        self.parallel = parallel
        self.progress = progress

    def _log(self, msg: str):
        if self.progress:
            print(msg, flush=True)

    # -- taxonomy -----------------------------------------------------------

    def download_taxonomy(self) -> str:
        """Fetch and extract the NCBI taxdump (download_taxonomy.sh).

        Writes nodes.dmp / names.dmp / merged.dmp under <db>/taxonomy.
        Accession-to-taxid maps are not needed: seqid2taxid.map is built
        from assembly_summary taxids at library download time.
        """
        tdir = os.path.join(self.db_dir, "taxonomy")
        os.makedirs(tdir, exist_ok=True)
        self._log("Downloading NCBI taxdump...")
        blob = self.fetch(f"{NCBI}/pub/taxonomy/taxdump.tar.gz")
        with tarfile.open(fileobj=io.BytesIO(blob), mode="r:gz") as tf:
            for name in ("nodes.dmp", "names.dmp", "merged.dmp"):
                member = tf.getmember(name)
                src = tf.extractfile(member)
                assert src is not None
                with open(os.path.join(tdir, name), "wb") as dst:
                    dst.write(src.read())
        self._log(f"Taxonomy extracted to {tdir}")
        return tdir

    # -- genomic libraries --------------------------------------------------

    def _assembly_summary(self, name: str) -> List[Dict[str, str]]:
        if name == "human":
            path = "/genomes/refseq/vertebrate_mammalian/Homo_sapiens/assembly_summary.txt"
        elif name == "refseq":
            path = "/genomes/refseq/assembly_summary_refseq.txt"
        else:
            path = f"/genomes/refseq/{name}/assembly_summary.txt"
        text = self.fetch(NCBI + path).decode("utf-8", "replace")
        rows = []
        header: List[str] = []
        for line in text.splitlines():
            if line.startswith("#assembly_accession") or line.startswith("# assembly_accession"):
                header = line.lstrip("# ").split("\t")
                continue
            if line.startswith("#") or not line.strip():
                continue
            parts = line.split("\t")
            if header and len(parts) >= len(header):
                rows.append(dict(zip(header, parts)))
            elif len(parts) > 19:  # positional fallback
                rows.append(
                    {
                        "assembly_accession": parts[0],
                        "taxid": parts[5],
                        "species_taxid": parts[6],
                        "assembly_level": parts[11],
                        "version_status": parts[10],
                        "ftp_path": parts[19],
                    }
                )
        return rows

    @staticmethod
    def _genomic_url(ftp_path: str) -> str:
        # rsync_from_ncbi.pl derives <basename>_genomic.fna.gz under the
        # assembly directory; serve it over https instead of rsync/ftp
        base = ftp_path.rstrip("/").rsplit("/", 1)[-1]
        url = ftp_path.replace("ftp://ftp.ncbi.nlm.nih.gov", NCBI)
        url = url.replace("http://ftp.ncbi.nlm.nih.gov", NCBI)
        return f"{url}/{base}_genomic.fna.gz"

    def download_library(
        self,
        name: str,
        level: str = "Complete Genome",
        max_assemblies: Optional[int] = None,
        mask: bool = False,
    ) -> Tuple[int, int]:
        """Download one genomic library (download_genomic_library.sh).

        level: minimum assembly completeness; assemblies at this level or
        better are kept ("prefer complete" sets = "Chromosome"). Only
        `latest` version_status rows are taken. Appends to
        <db>/seqid2taxid.map, mapping every sequence id of an assembly to
        the assembly taxid. Returns (n_assemblies, n_sequences).
        """
        if name in OTHER_LIBRARIES:
            return self._download_special(name, mask)
        if name not in REFSEQ_LIBRARIES and name != "refseq":
            raise ValueError(
                f"unsupported library {name!r} (supported: "
                f"{', '.join(REFSEQ_LIBRARIES + OTHER_LIBRARIES)}, refseq)"
            )
        keep_levels = set(ASSEMBLY_LEVELS[: ASSEMBLY_LEVELS.index(level) + 1])
        rows = [
            r
            for r in self._assembly_summary(name)
            if r.get("assembly_level") in keep_levels
            and r.get("version_status", "latest") == "latest"
            and r.get("ftp_path") not in (None, "", "na")
        ]
        if max_assemblies:
            rows = rows[:max_assemblies]
        lib_dir = os.path.join(self.db_dir, "library", name)
        os.makedirs(lib_dir, exist_ok=True)
        self._log(f"{name}: downloading {len(rows)} assemblies ({self.parallel} threads)")

        labels: List[Tuple[str, int]] = []
        n_seqs = 0

        def work(row):
            url = self._genomic_url(row["ftp_path"])
            fname = url.rsplit("/", 1)[-1]
            data = self.fetch(url)
            if mask:
                data = gzip.compress(
                    mask_low_complexity_fasta(gzip.decompress(data)), 1
                )
            with open(os.path.join(lib_dir, fname), "wb") as f:
                f.write(data)
            taxid = int(row["taxid"])
            ids = fasta_sequence_ids(gzip.decompress(data))
            return [(sid, taxid) for sid in ids]

        with ThreadPoolExecutor(self.parallel) as pool:
            for got in pool.map(work, rows):
                labels += got
                n_seqs += len(got)

        self._append_labels(labels)
        self._log(f"{name}: {len(rows)} assemblies, {n_seqs} sequences")
        return len(rows), n_seqs

    def _download_special(self, name: str, mask: bool) -> Tuple[int, int]:
        """plasmid / UniVec libraries (non-refseq layout)."""
        lib_dir = os.path.join(self.db_dir, "library", name)
        os.makedirs(lib_dir, exist_ok=True)
        if name == "plasmid":
            # genbank plasmid multi-volume fna set; volume count discovered
            # by probing until 404 (the reference globs the rsync listing)
            labels: List[Tuple[str, int]] = []
            n_files = 0
            vol = 1
            while True:
                url = f"{NCBI}/genomes/genbank/plasmid/plasmid.{vol}.1.genomic.fna.gz"
                try:
                    data = self.fetch(url)
                except Exception:  # noqa: BLE001 (404/terminal: stop probing)
                    break
                with open(os.path.join(lib_dir, f"plasmid.{vol}.1.genomic.fna.gz"), "wb") as f:
                    f.write(data)
                # plasmids have no per-assembly taxid; taxon 36549 (plasmids)
                # mirrors the reference's special taxid handling
                labels += [(sid, 36549) for sid in fasta_sequence_ids(gzip.decompress(data))]
                n_files += 1
                vol += 1
            self._append_labels(labels)
            return n_files, len(labels)
        # UniVec / UniVec_Core: vector contamination screens, taxid 28384
        # ("other sequences") per the k2 scripts
        url = f"{NCBI}/pub/UniVec/{name}"
        data = self.fetch(url)
        out = os.path.join(lib_dir, f"{name}.fna.gz")
        with open(out, "wb") as f:
            f.write(gzip.compress(data, 1))
        labels = [(sid, 28384) for sid in fasta_sequence_ids(data)]
        self._append_labels(labels)
        return 1, len(labels)

    def _append_labels(self, labels: Iterable[Tuple[str, int]]):
        path = os.path.join(self.db_dir, "seqid2taxid.map")
        with open(path, "a") as f:
            for sid, taxid in labels:
                f.write(f"{sid}\t{taxid}\n")

    def download_standard(self, level: str = "Complete Genome") -> Dict[str, Tuple[int, int]]:
        """The Kraken 2 standard collection (download_standard.sh):
        taxonomy + archaea, bacteria, viral, plasmid, human, UniVec_Core."""
        self.download_taxonomy()
        out = {}
        for name in STANDARD_LIBRARIES:
            out[name] = self.download_library(name, level=level)
        return out


# ---------------------------------------------------------------------------
# FASTA helpers
# ---------------------------------------------------------------------------


def fasta_sequence_ids(data: bytes) -> List[str]:
    """First header token of every record (what seqid2taxid.map keys on,
    scan_fasta_file.pl)."""
    out = []
    for line in data.split(b"\n"):
        if line.startswith(b">"):
            out.append(line[1:].split()[0].decode("ascii", "replace"))
    return out


def make_fai(path: str) -> str:
    """Generate a samtools-compatible .fai for an uncompressed FASTA (the
    reference runs seqkit faidx after download). Requires uniform line
    lengths per record, like samtools."""
    entries = []
    with open(path, "rb") as f:
        name = None
        seq_len = 0
        offset = 0
        linebases = linewidth = 0
        pos = 0
        for raw in f:
            if raw.startswith(b">"):
                if name is not None:
                    entries.append((name, seq_len, offset, linebases, linewidth))
                name = raw[1:].split()[0].decode()
                pos += len(raw)
                offset = pos
                seq_len = 0
                linebases = linewidth = 0
            else:
                stripped = raw.rstrip(b"\r\n")
                if linebases == 0 and stripped:
                    linebases = len(stripped)
                    linewidth = len(raw)
                seq_len += len(stripped)
                pos += len(raw)
        if name is not None:
            entries.append((name, seq_len, offset, linebases, linewidth))
    fai = path + ".fai"
    with open(fai, "w") as f:
        for e in entries:
            f.write("\t".join(str(x) for x in e) + "\n")
    return fai


# ---------------------------------------------------------------------------
# Low-complexity masking (mask_low_complexity.sh / k2mask replacement)
# ---------------------------------------------------------------------------


def mask_low_complexity(seq: np.ndarray, window: int = 64, threshold: float = 1.2) -> np.ndarray:
    """Mask low-complexity regions of a 2-bit-coded sequence to code 4 (N).

    Windowed Shannon entropy over base composition: positions whose
    surrounding `window` has entropy below `threshold` bits are masked.
    This replaces the external k2mask (SDUST) binary with a native filter
    of the same purpose — suppressing simple repeats (poly-A, (AT)n, ...)
    that would otherwise create hugely over-shared minimizers. Exact SDUST
    triplet scoring is not reproduced; thresholds: random sequence has
    entropy ~2.0 bits, (AT)n repeats 1.0, homopolymers 0.0.
    """
    codes = np.asarray(seq, np.uint8)
    n = len(codes)
    if n < window:
        return codes
    valid = codes < 4
    counts = np.zeros((4, n), np.int32)
    for b in range(4):
        counts[b] = np.cumsum((codes == b).astype(np.int32))
    w = window
    tot = np.zeros((4, n - w + 1), np.float64)
    for b in range(4):
        tot[b] = counts[b, w - 1 :] - np.concatenate([[0], counts[b, : n - w]])
    denom = tot.sum(0)
    denom[denom == 0] = 1
    p = tot / denom
    with np.errstate(divide="ignore", invalid="ignore"):
        ent = -(p * np.where(p > 0, np.log2(p, where=p > 0), 0)).sum(0)
    low = ent < threshold
    # a window's mask covers all its positions
    mask = np.zeros(n, bool)
    starts = np.flatnonzero(low)
    for s in starts:
        mask[s : s + w] = True
    out = codes.copy()
    out[mask & valid] = 4
    return out


_CODE = np.full(256, 4, np.uint8)
for i, ch in enumerate("ACGT"):
    _CODE[ord(ch)] = i
    _CODE[ord(ch.lower())] = i


def mask_low_complexity_fasta(data: bytes, window: int = 64, threshold: float = 1.2) -> bytes:
    """Apply mask_low_complexity to every record of a FASTA byte blob,
    writing masked bases as 'N' (the lossy hard-mask the k2 pipeline's
    `sed -e '/^>/!s/x/N/g'` step produces)."""
    out_lines: List[bytes] = []
    for chunk in data.split(b"\n"):
        if chunk.startswith(b">") or not chunk:
            out_lines.append(chunk)
            continue
        arr = np.frombuffer(chunk, np.uint8)
        codes = _CODE[arr]
        masked = mask_low_complexity(codes, window, threshold)
        line = arr.copy()
        line[(masked == 4)] = ord("N")
        out_lines.append(line.tobytes())
    return b"\n".join(out_lines)
