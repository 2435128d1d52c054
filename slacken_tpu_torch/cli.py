"""Command-line interface of the port: `build` and `classify` (reports mode).
Run as `python -m slacken_tpu_torch.cli <subcommand>`; options match
slacken_tpu's CLI, plus --device (default cuda)."""

from __future__ import annotations

import argparse
import sys
import time

LATER = "ROADMAP.md, port queue"


def _build_parser():
    ap = argparse.ArgumentParser(
        prog="slacken_tpu_torch", description="Metagenomic classifier (Kraken 2 algorithm) on PyTorch/CUDA"
    )
    sub = ap.add_subparsers(dest="command", required=True)

    b = sub.add_parser("build", help="Build a new index from genomes with taxa")
    b.add_argument("-i", "--index", required=True, help="Output index location")
    b.add_argument("-l", "--library", required=True, help="Genome library directory (contains library/)")
    b.add_argument("-t", "--taxonomy", required=True, help="Taxonomy directory (nodes.dmp, names.dmp, merged.dmp)")
    b.add_argument("-k", type=int, default=35, help="k-mer length (default 35)")
    b.add_argument("-m", type=int, default=31, help="minimizer width (default 31, at most 31)")
    b.add_argument("-s", "--spaces", type=int, default=7, help="spaced seed spaces (default 7)")
    b.add_argument("-p", "--partitions", type=int, default=200, help="shard count hint")
    b.add_argument("--device", default="cuda", help="torch device (default cuda)")

    c = sub.add_parser("classify", help="Classify genomic sequences")
    c.add_argument("-i", "--index", required=True, help="Index location")
    c.add_argument("inputs", nargs="*", help="Sequence files to classify")
    c.add_argument("--min-hits", type=int, default=2, help="Minimum hit groups (default 2)")
    c.add_argument("-p", "--paired", action="store_true", help="Inputs are paired-end reads")
    c.add_argument("--no-unclassified", action="store_true", help="Omit unclassified reads")
    c.add_argument("-o", "--output", required=True, help="Output location")
    c.add_argument("--no-detailed", action="store_true", help="Only reports, no per-read output")
    c.add_argument("-c", "--confidence", type=float, nargs="+", default=[0.0],
                   help="Confidence thresholds in [0,1]")
    c.add_argument("--sample-regex", help="Regex extracting sample ID from read headers")
    c.add_argument("--device", default="cuda", help="torch device (default cuda)")
    return ap


def main(argv=None):
    args = _build_parser().parse_args(argv)
    from . import get_device

    device = get_device(args.device)
    t0 = time.time()
    try:
        rc = COMMANDS[args.command](args, device)
    except FileNotFoundError as e:
        print(f"slacken_tpu_torch {args.command}: error: {e}", file=sys.stderr)
        return 2
    print(f"Total time: {time.time() - t0:.1f} s", file=sys.stderr)
    return rc or 0


def cmd_build(args, device):
    from slacken_tpu.taxonomy import Taxonomy

    from .index import IndexParams, KeyValueIndex
    from .inputs import GenomeLibrary

    tax = Taxonomy.load(args.taxonomy)
    lib = GenomeLibrary.from_directory(args.library)
    print(f"Discovered {len(lib.files)} genome files")
    params = IndexParams(k=args.k, m=args.m, spaces=args.spaces, buckets=args.partitions)
    idx = KeyValueIndex.build(lib.taxa_sequences(), params, tax, device)
    idx.save(args.index)
    print(f"Saved {idx.num_records} records to {args.index}")
    return 0


def cmd_classify(args, device):
    from .classify import Classifier, ClassifyParams
    from .index import KeyValueIndex
    from .inputs import expand_file_list, packed_reads_from_file

    if args.paired:
        print(f"slacken_tpu_torch classify: --paired input is a later slice ({LATER})",
              file=sys.stderr)
        return 2
    if not args.no_detailed:
        print(f"slacken_tpu_torch classify: per-read output is a later slice; "
              f"pass --no-detailed ({LATER})", file=sys.stderr)
        return 2
    for c in args.confidence:
        if c < 0 or c > 1:
            sys.exit(f"--confidence values must be in [0, 1] ({c} was given)")
    cpar = ClassifyParams(
        min_hit_groups=args.min_hits,
        with_unclassified=not args.no_unclassified,
        thresholds=list(args.confidence),
        sample_regex=args.sample_regex,
        per_read_output=False,
    )
    cls = Classifier(KeyValueIndex.load(args.index), device)
    files = expand_file_list(args.inputs)
    stream = (p for path in files for p in packed_reads_from_file(path))
    samples = cls.classify_and_write_packed(stream, args.output, cpar)
    for t, ss in samples.items():
        print(f"threshold {t}: samples {ss}")
    return 0


COMMANDS = {"build": cmd_build, "classify": cmd_classify}


if __name__ == "__main__":
    sys.exit(main())
