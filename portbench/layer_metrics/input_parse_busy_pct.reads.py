"""input_parse_busy_pct.reads: the host's seconds inside next() of the
paired FASTQ stream that the benchmark hands the classifier (the CLI's
reader, inputs.packed_pairs_from_files, and the native packer under it),
summed over the traced requests, over the traced stretch (%). The stream
runs in the classifier's prefetch thread, so this is the share of the
stretch in which parsing kept that thread busy."""


def read(context):
    r, parse = context.get("reading"), context.get("parse_s")
    if r is None or r.window_s <= 0 or not parse:
        return None
    return 100.0 * sum(parse) / r.window_s
