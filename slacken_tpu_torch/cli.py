"""Command-line interface of the port: `build` (--ordering for an explicit
minimizer ordering, -m up to 63 for wide keys, --full-records for the
sidecar that makes dynamic builds a filter, --spill-dir for range files in
place of host memory where the build's leaves leave the device, --check to
only check the inputs), `classify` (per-read output by default, --no-detailed for reports
only, -p for paired files), `classify2` (two-step classification with a
dynamic index, --bracken-length for its Bracken weights), `bracken-build`,
`respace`, `stats`, `inspect`, `compareIndex`, `compare`, `inputCheck` and
`download`. Run as `python -m slacken_tpu_torch.cli <subcommand>`; options
match slacken_tpu's CLI, plus --device (default cuda) on every subcommand
that works on a device (`compare`, `inputCheck` and `download` do not).
`build --devices N [--shards S]`, `classify --devices N --layout
replicated|ring` and `classify2 --devices N --layout ...` run over a mesh of
N devices of --device's kind (N cards, or N shards of the CPU with --device
cpu) in one process; N above the machine's number of cards raises.
`classify --coordinator host:port --num-processes P --process-id p` runs
over P processes (parallel/multihost.py: one ring of index shards through
every process's --devices entries, default 1, the rank's card).
`classify` and `classify2` take --probe as slacken_tpu's CLI does: routed
(the default, or STPU_PROBE), tiled, hashed1, hashed, hashed128 or
bucketed, on one device, over a mesh (where hashed128 and bucketed run the
routed probe, as in slacken_tpu) and over processes; a wide index takes
routed, tiled or hashed1 (--coordinator: routed, tiled, hashed or hashed1,
wide routed or hashed1, hashed128 and bucketed refused; STPU_MH_PROBE
without --probe)."""

from __future__ import annotations

import argparse
import json
import sys
import time


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
    b.add_argument("-m", type=int, default=31, help="minimizer width (default 31, at most 63; at most 15 with an --ordering other than xor)")
    b.add_argument("-s", "--spaces", type=int, default=7, help="spaced seed spaces (default 7)")
    b.add_argument("-p", "--partitions", type=int, default=200, help="shard count hint")
    b.add_argument("--check", action="store_true", help="Only check input files for consistency")
    b.add_argument("--ordering", choices=["xor", "lexicographic", "signature", "frequency"], default="xor",
                   help="Minimizer ordering (default xor = Kraken 2-compatible RandomXOR; frequency samples "
                        "the library and prefers rare minimizers; signature = KMC2/3 signature ordering)")
    b.add_argument("--full-records", action="store_true",
                   help="Also store the full (minimizer, taxon) records, enabling fast dynamic (classify2) rebuilds")
    b.add_argument("--spill-dir",
                   help="Range-partitioned on-disk spill directory for beyond-RAM builds: leaves that leave the "
                        "device go to range files there in place of host memory (removed after the build)")
    b.add_argument("--devices", type=int, help="Build with the key-range shuffle on an n-device mesh")
    b.add_argument("--shards", type=int,
                   help="Save the index as N contiguous key-range shard files (the save_sharded layout)")
    _add_device(b)

    c = sub.add_parser("classify", help="Classify genomic sequences")
    _add_classify_opts(c)
    c.add_argument("--coordinator",
                   help="Multi-process mode: the process group's rendezvous address (host:port, served by process "
                        "0); run the same command in every process")
    c.add_argument("--num-processes", type=int, help="Multi-process mode: total process count")
    c.add_argument("--process-id", type=int, help="Multi-process mode: this process's id")

    c2 = sub.add_parser("classify2", help="Two-step classification with a dynamic index built on the fly")
    _add_classify_opts(c2)
    c2.add_argument("-l", "--library", required=True, help="Genome library for dynamic index construction")
    c2.add_argument("--rank", default="species", help="Granularity for index construction (default species)")
    c2.add_argument("-C", "--min-count", type=int, help="Minimizer total count criterion")
    c2.add_argument("-D", "--min-distinct", type=int, help="Minimizer distinct count criterion")
    c2.add_argument("-R", "--reads", type=int, help="Classified read count criterion (default 100)")
    c2.add_argument("-F", "--min-fraction", type=float,
                    help="Minimizer fraction criterion: keep clades whose distinct hits "
                         "cover >= this fraction of the clade's index minimizers")
    c2.add_argument("--init-confidence", type=float, default=0.15, help="Confidence for step-1 classification")
    c2.add_argument("--bracken-length", type=int, help="Read length for dynamic bracken weights")
    c2.add_argument("--index-reports", action="store_true", help="Report on the dynamic index")
    c2.add_argument("--classify-with-gold", action="store_true", help="Use gold taxon set for the dynamic library")
    c2.add_argument("-g", "--gold-set", help="Gold standard taxon set file")
    c2.add_argument("--promote-gold-set", help="Promote unmatched gold taxa to this rank")

    bb = sub.add_parser("bracken-build", help="Generate Bracken weights (kmer_distrib)")
    bb.add_argument("-i", "--index", required=True)
    bb.add_argument("-l", "--library", required=True)
    bb.add_argument("--read-len", type=int, default=100)
    bb.add_argument("--no-gradual", action="store_true",
                    help="Disable gradual (chunked, resumable) weight building; the default matches the "
                         "reference CLI's gradual=true (Slacken.scala:276)")
    _add_device(bb)

    r = sub.add_parser("respace", help="Derive new indexes with more spaced-seed spaces")
    r.add_argument("-i", "--index", required=True)
    r.add_argument("-o", "--output", required=True)
    r.add_argument("--spaces", type=int, nargs="+", required=True)
    _add_device(r)

    st = sub.add_parser("stats", help="Index statistics")
    st.add_argument("-i", "--index", required=True)
    st.add_argument("-l", "--library", help="Genome library for coverage check")
    st.add_argument("--histogram", action="store_true", help="Taxonomic depth histograms")
    _add_device(st)

    ins = sub.add_parser("inspect", help="Generate index contents reports")
    ins.add_argument("-i", "--index", required=True)
    ins.add_argument("-l", "--library")
    ins.add_argument("-o", "--output", required=True)
    ins.add_argument("--labels", help="Label file to check for missing taxa")
    _add_device(ins)

    ci = sub.add_parser("compareIndex", help="Compare minimizer LCAs between two indexes")
    ci.add_argument("-i", "--index", required=True)
    ci.add_argument("-r", "--reference", required=True)
    ci.add_argument("-o", "--output", required=True)
    _add_device(ci)

    cm = sub.add_parser("compare", help="Compare classifications against a reference mapping")
    cm.add_argument("-t", "--taxonomy", required=True)
    cm.add_argument("-r", "--reference", required=True)
    cm.add_argument("--id-col", type=int, default=2)
    cm.add_argument("-T", "--taxon-col", type=int, default=3)
    cm.add_argument("-o", "--output")
    cm.add_argument("--header", action="store_true")
    cm.add_argument("--multi-dirs", nargs="+")
    cm.add_argument("--test-files", nargs="+")
    cm.add_argument("--min-count", type=int, default=10)

    ic = sub.add_parser("inputCheck", help="Inspect input data")
    ic.add_argument("-t", "--taxonomy", required=True)
    ic.add_argument("--labels", help="Sequence taxonomic label file")

    dl = sub.add_parser("download", help="Download genome libraries + taxonomy from NCBI")
    dl.add_argument("what", nargs="+",
                    help="'taxonomy', 'standard', or library names (archaea bacteria viral fungi plant "
                         "human protozoa plasmid UniVec UniVec_Core refseq)")
    dl.add_argument("-d", "--db", required=True, help="Destination library directory")
    dl.add_argument("--level", default="Complete Genome",
                    choices=["Complete Genome", "Chromosome", "Scaffold", "Contig"],
                    help="Minimum assembly completeness (default 'Complete Genome'; "
                         "'Chromosome' = the prefer-complete rspc sets)")
    dl.add_argument("--max-assemblies", type=int, help="Cap assemblies per library")
    dl.add_argument("--mask", action="store_true",
                    help="Hard-mask low-complexity regions (native windowed-entropy filter replacing k2mask)")
    dl.add_argument("-j", "--jobs", type=int, default=4, help="Parallel downloads")
    return ap


def _add_device(p):
    p.add_argument("--device", default="cuda", help="torch device (default cuda)")


def _add_classify_opts(p):
    p.add_argument("-i", "--index", required=True, help="Index location")
    p.add_argument("inputs", nargs="*", help="Sequence files to classify")
    p.add_argument("--min-hits", type=int, default=2, help="Minimum hit groups (default 2)")
    p.add_argument("-p", "--paired", action="store_true", help="Inputs are paired-end reads")
    p.add_argument("--no-unclassified", action="store_true", help="Omit unclassified reads")
    p.add_argument("-o", "--output", required=True, help="Output location")
    p.add_argument("--no-detailed", action="store_true", help="Only reports, no per-read output")
    p.add_argument("-c", "--confidence", type=float, nargs="+", default=[0.0],
                   help="Confidence thresholds in [0,1]")
    p.add_argument("--sample-regex", help="Regex extracting sample ID from read headers")
    p.add_argument("--devices", type=int, help="Classify over an n-device mesh (default: single device)")
    p.add_argument("--layout", choices=["replicated", "ring"],
                   help="Mesh index layout: replicated (the index on every device) or ring "
                        "(range-sharded index, queries going round the devices)")
    p.add_argument("--probe", choices=["routed", "tiled", "hashed", "hashed1", "hashed128", "bucketed"],
                   help="Index probe: routed (the prefix directory; default, or STPU_PROBE), tiled (router and "
                        "row table), hashed1 (row-bucket hash table), hashed and hashed128 (displacement-bounded "
                        "hash table, slot rows or column blocks) or bucketed (router and padded keys); the "
                        "answers are the same. Wide (m > 31) indexes take routed, tiled and hashed1")
    _add_device(p)


def _cpar(args):
    from .classify import ClassifyParams

    for c in args.confidence:
        if c < 0 or c > 1:
            sys.exit(f"--confidence values must be in [0, 1] ({c} was given)")
    return ClassifyParams(
        min_hit_groups=args.min_hits,
        with_unclassified=not args.no_unclassified,
        thresholds=list(args.confidence),
        sample_regex=args.sample_regex,
        per_read_output=not args.no_detailed,
    )


def main(argv=None):
    args = _build_parser().parse_args(argv)
    from . import get_device

    # compare, inputCheck and download do no device work and take no --device
    device = get_device(args.device) if "device" in args else None
    t0 = time.time()
    try:
        rc = COMMANDS[args.command](args, device)
    except FileNotFoundError as e:
        print(f"slacken_tpu_torch {args.command}: error: {e}", file=sys.stderr)
        return 2
    print(f"Total time: {time.time() - t0:.1f} s", file=sys.stderr)
    return rc or 0


def cmd_build(args, device):
    from .index import IndexParams, KeyValueIndex
    from .inputs import GenomeLibrary
    from .taxonomy import Taxonomy

    tax = Taxonomy.load(args.taxonomy)
    lib = GenomeLibrary.from_directory(args.library)
    print(f"Discovered {len(lib.files)} genome files")
    if args.check:
        from .inputs import check_input

        check_input(lib, args.k)
        print(json.dumps(lib.input_stats(tax), indent=2))
        return 0
    params = IndexParams(k=args.k, m=args.m, spaces=args.spaces, buckets=args.partitions,
                         ordering=args.ordering)
    ordering_lut = None
    if args.ordering == "frequency":
        from .ops import encode, ordering

        print("Sampling m-mer frequencies over the library...")
        counts = ordering.sample_mmer_counts(
            (encode.encode_seq(seq) for _, seq in lib.taxa_sequences()), params.minimizer_params, device)
        ordering_lut = ordering.frequency_lut(counts, args.m)
    if args.devices:
        from .parallel.classifier import build_distributed
        from .parallel.mesh import make_mesh

        idx = build_distributed(lib.taxa_sequences(), params, tax, make_mesh(args.devices, device),
                                ordering_lut=ordering_lut, keep_records=args.full_records, spill_dir=args.spill_dir)
    else:
        idx = KeyValueIndex.build(lib.taxa_sequences(), params, tax, device, ordering_lut=ordering_lut,
                                  keep_records=args.full_records, spill_dir=args.spill_dir)
    if args.shards:
        idx.save_sharded(args.index, n_shards=args.shards)
        print(f"Saved {idx.num_records} records to {args.index} ({args.shards} shards)")
    else:
        idx.save(args.index)
        print(f"Saved {idx.num_records} records to {args.index}")
    _show_index_stats(idx)
    print(json.dumps(lib.input_stats(tax), indent=2))
    return 0


def cmd_classify(args, device):
    from .index import KeyValueIndex
    from .inputs import (
        MatesOutOfOrder,
        expand_file_list,
        fragments_from_files,
        packed_pairs_from_files,
        packed_reads_from_file,
    )
    from .parallel.classifier import make_classifier

    cpar = _cpar(args)  # validate before any heavy work
    if args.coordinator or args.num_processes:
        return _classify_multihost(args, cpar, device)
    idx = KeyValueIndex.load(args.index)
    cls = make_classifier(idx, device, args.devices, args.layout, probe=args.probe)
    files = expand_file_list(args.inputs)
    if not args.paired:
        stream = (p for path in files for p in packed_reads_from_file(path))
        samples = cls.classify_and_write_packed(stream, args.output, cpar)
    else:
        stream = (p for f1, f2 in zip(files[0::2], files[1::2])
                  for p in packed_pairs_from_files(f1, f2))
        try:
            samples = cls.classify_and_write_packed(stream, args.output, cpar)
        except MatesOutOfOrder:
            # only the pairing reader's own error: fall back to the reader
            # that joins mates by id; any other error of the run propagates
            frags = fragments_from_files(files, paired=True, k=idx.params.k)
            samples = cls.classify_and_write(frags, args.output, cpar)
    for t, ss in samples.items():
        print(f"threshold {t}: samples {ss}")
    return 0


def _classify_multihost(args, cpar, device):
    """classify over several processes, one a rank of a torch.distributed
    group (NCCL on the card, gloo on the CPU), the index range-sharded across
    them and the queries going round one ring through every process's
    --devices entries (default 1: the rank's card, cuda:<local rank>). Needs
    a sharded index (build --shards S, S a multiple of the ring's entries).
    Every process reads the inputs whole and classifies its contiguous share
    of the reads; each writes its part files, process 0 the merged
    kreports."""
    import os

    from .inputs import expand_file_list, packed_reads_from_file
    from .parallel import multihost as mh

    if args.paired:
        raise SystemExit("multi-host classify does not support --paired yet")
    if args.layout == "replicated":
        raise SystemExit("multi-host classify does not support --layout replicated (the index is range-sharded "
                         "across the processes: the ring layout)")
    if args.probe not in (None, "routed", "tiled", "hashed", "hashed1"):
        raise SystemExit(f"multi-host classify supports --probe routed/tiled/hashed/hashed1, not {args.probe!r}")
    ctx = mh.initialize(args.coordinator, args.num_processes, args.process_id, device, args.devices)
    try:
        files = expand_file_list(args.inputs)
        cls = mh.MultiHostRingClassifier(args.index, ctx, mh_probe=args.probe)
        rows = os.environ.get("STPU_MH_ROWS")
        samples = cls.classify_and_write_stream(
            lambda: (p for path in files for p in packed_reads_from_file(path)), args.output, cpar,
            int(rows) if rows else None)
        n_disp, rows, bucket = cls.lockstep
        print(f"process {ctx.process_index} of {ctx.process_count} ({ctx.backend}, local {ctx.mesh}): {n_disp} "
              f"batches of {rows} x {bucket}, {cls.padding_dispatches} all padding; {cls.p2p_bytes} bytes sent to "
              "the next process", file=sys.stderr)
        if ctx.process_index == 0:
            for t, ss in samples.items():
                print(f"threshold {t}: samples {ss}")
    finally:
        mh.shutdown()
    return 0


def cmd_classify2(args, device):
    from .dynamic import Dynamic, GoldSetOptions, criteria_from_args
    from .index import KeyValueIndex
    from .inputs import (
        GenomeLibrary,
        MatesOutOfOrder,
        expand_file_list,
        fragments_from_files,
        packed_pairs_from_files,
        packed_reads_from_file,
    )
    from .taxonomy import RANK_DEPTH

    cpar = _cpar(args)
    idx = KeyValueIndex.load(args.index).to(device)
    lib = GenomeLibrary.from_directory(args.library)
    gold = None
    if args.gold_set:
        promote = RANK_DEPTH.get(args.promote_gold_set) if args.promote_gold_set else None
        gold = GoldSetOptions(args.gold_set, promote, args.classify_with_gold)
    dyn = Dynamic(idx, lib, RANK_DEPTH.get(args.rank, 8), criteria_from_args(args), cpar, gold,
                  args.output, device, devices=args.devices, layout=args.layout, probe=args.probe)
    files_factory = lambda: fragments_from_files(args.inputs, paired=args.paired, k=idx.params.k)  # noqa: E731
    # the final classification takes the native packed streaming path (the
    # same writer the 1-step CLI uses); the dynamic-criteria pass keeps the
    # Fragment stream (it feeds the span-hit counting)
    files = expand_file_list(args.inputs)
    if not args.paired:
        packed_factory = lambda: (p for path in files for p in packed_reads_from_file(path))  # noqa: E731
        dyn.two_step_classify_and_write(files_factory, args.index_reports, args.bracken_length,
                                        packed_factory=packed_factory)
        return 0
    packed_factory = lambda: (p for f1, f2 in zip(files[0::2], files[1::2])  # noqa: E731
                              for p in packed_pairs_from_files(f1, f2))
    try:
        dyn.two_step_classify_and_write(files_factory, args.index_reports, args.bracken_length,
                                        packed_factory=packed_factory)
    except MatesOutOfOrder:
        # only the pairing reader's own error: run again with the reader that
        # joins mates by id in the final pass too; any other error propagates
        dyn.two_step_classify_and_write(files_factory, args.index_reports, args.bracken_length)
    return 0


def cmd_bracken_build(args, device):
    from .bracken import BrackenWeights
    from .index import KeyValueIndex
    from .inputs import GenomeLibrary

    idx = KeyValueIndex.load(args.index).to(device)
    lib = GenomeLibrary.from_directory(args.library)
    out = f"{args.index}_bracken/database{args.read_len}mers.kmer_distrib"
    bw = BrackenWeights(idx, args.read_len, device=device)
    # gradual (chunked, durable, resumable) by default, as the reference CLI
    # (Slacken.scala:276): a rerun after a kill resumes from the chunk files
    bw.build_and_write_weights(lib, lib.taxon_set(idx.taxonomy), out, gradual=not args.no_gradual)
    print(f"Wrote {out}")
    return 0


def cmd_respace(args, device):
    from .index import KeyValueIndex

    idx = KeyValueIndex.load(args.index).to(device)
    for s in args.spaces:
        out = args.output.replace("_s%d" % idx.params.spaces, "_s%d" % s)
        if out == args.output:
            out = f"{args.output}_s{s}"
        new = idx.respace(s)
        new.save(out)
        print(f"Respaced to s={s}: {new.num_records} records at {out}")
        _show_index_stats(new)
    return 0


def _show_index_stats(idx):
    per_taxon = idx.records_per_taxon()
    leaf = {t: c for t, c in per_taxon.items() if idx.taxonomy.is_leaf(t)}
    tree_size = idx.taxonomy.count_distinct_taxa_with_ancestors(per_taxon.keys())
    total = sum(per_taxon.values())
    leaf_total = sum(leaf.values())
    print(
        f"Tree size: {tree_size} taxa, stored taxa: {len(per_taxon)}, of which "
        f"{len(leaf)} leaf taxa ({100.0 * len(leaf) / max(len(per_taxon), 1):.2f}%)"
    )
    print(
        f"Total {idx.params.m}-minimizers: {total}, of which leaf records: "
        f"{leaf_total} ({100.0 * leaf_total / max(total, 1):.2f}%)"
    )


def cmd_stats(args, device):
    from .index import KeyValueIndex
    from .stats import depth_histograms, show_coverage_stats

    idx = KeyValueIndex.load(args.index).to(device)
    p = idx.params
    print(f"Index {args.index}: k={p.k} m={p.m} spaces={p.spaces} "
          f"toggle=0x{p.toggle_mask:x} canonical={p.canonical} records={idx.num_records}")
    if args.histogram:
        kmer_h, taxon_h = depth_histograms(idx)
        print("Minimizer depth histogram")
        for depth, rank, count in kmer_h:
            print(f"  {depth}\t{rank}\t{count}")
        print("Taxon depth histogram")
        for depth, rank, count in taxon_h:
            print(f"  {depth}\t{rank}\t{count}")
    else:
        _show_index_stats(idx)
        if args.library:
            from .inputs import GenomeLibrary

            show_coverage_stats(idx, GenomeLibrary.from_directory(args.library), device)
    return 0


def cmd_inspect(args, device):
    from .index import KeyValueIndex
    from .stats import write_inspect_reports

    idx = KeyValueIndex.load(args.index).to(device)
    lib = None
    if args.library:
        from .inputs import GenomeLibrary

        lib = GenomeLibrary.from_directory(args.library)
    write_inspect_reports(idx, args.output, labels=args.labels, library=lib, device=device)
    return 0


def cmd_compare_index(args, device):
    from .analysis.migration import MinimizerMigration
    from .index import KeyValueIndex

    idx = KeyValueIndex.load(args.index)
    ref = KeyValueIndex.load(args.reference)
    MinimizerMigration(idx, ref, device).run(args.output)
    return 0


def cmd_compare(args, device):
    from .analysis.mapping_comparison import MappingComparison
    from .taxonomy import Taxonomy

    tax = Taxonomy.load(args.taxonomy)
    mc = MappingComparison(tax, args.id_col, args.taxon_col, args.header, args.min_count, bool(args.multi_dirs))
    if args.test_files:
        mc.process_files(args.test_files, args.output, args.reference)
    else:
        mc.process_directories(args.multi_dirs, args.output, args.reference)
    return 0


def cmd_input_check(args, device):
    from .inputs import GenomeLibrary
    from .taxonomy import Taxonomy

    tax = Taxonomy.load(args.taxonomy)
    if args.labels:
        lib = GenomeLibrary([], args.labels)
        print(json.dumps(lib.input_stats(tax), indent=2))
    return 0


def cmd_download(args, device):
    from .download import LibraryDownloader

    dl = LibraryDownloader(args.db, parallel=args.jobs)
    for what in args.what:
        if what == "taxonomy":
            dl.download_taxonomy()
        elif what == "standard":
            dl.download_standard(level=args.level)
        else:
            n_asm, n_seq = dl.download_library(what, level=args.level, max_assemblies=args.max_assemblies,
                                               mask=args.mask)
            print(f"{what}: {n_asm} assemblies, {n_seq} sequences")
    return 0


COMMANDS = {
    "build": cmd_build,
    "classify": cmd_classify,
    "classify2": cmd_classify2,
    "bracken-build": cmd_bracken_build,
    "respace": cmd_respace,
    "stats": cmd_stats,
    "inspect": cmd_inspect,
    "compareIndex": cmd_compare_index,
    "compare": cmd_compare,
    "inputCheck": cmd_input_check,
    "download": cmd_download,
}


if __name__ == "__main__":
    sys.exit(main())
