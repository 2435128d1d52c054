"""d2h_bytes_per_read.reads: the bytes the classifier copied to the host
(d2h_bytes of its dispatch spans, the bundle and in per-read mode the
window taxa or hit runs, and of its harvest spans, the rows fetched
synchronously) per read classified (B/read)."""

from portbench.pbcore.spans import per_read


def read(context):
    return per_read(context, "d2h_bytes")
