"""chain_roofline: the least time of the traced requests' classify work
at the card's memory rate, over the device's busy time in the traced
stretch (every kernel and copy, overlaps counted once) (%). The least bytes
count the work, whatever implements it: each base once at 2 bits and a
position's ambiguity bit, one 32-byte sector for each distinct valid
minimizer of the sample (the probe of each once), and each read's result
once (4 bytes a threshold). A sample's distinct minimizers are never more
than its batches' summed, so this stays a lower bound however the work is
batched, fused or replaced."""

from portbench.pbcore.roofline import least_seconds


def least_bytes(bases, distinct_minimizers, reads, thresholds):
    return bases * 3 / 8 + 32 * distinct_minimizers + 4 * thresholds * reads


def read(context):
    r = context.get("reading")
    if r is None or r.busy_s <= 0 or not context.get("bases"):
        return None
    n = sum(least_bytes(b, d, q, context["thresholds"]) for b, d, q in
            zip(context["bases"], context["distinct_minimizers"], context["reads"]))
    return 100.0 * least_seconds(n) / r.busy_s
