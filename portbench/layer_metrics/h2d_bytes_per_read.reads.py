"""h2d_bytes_per_read.reads: the bytes the classifier queued for copy to the
device (its dispatch spans' h2d_bytes: 2-bit codes, validity bits,
ambiguity counts, and in hit-runs mode splits and lengths, padded rows
included) per read classified (B/read)."""

from portbench.pbcore.spans import per_read


def read(context):
    return per_read(context, "h2d_bytes")
