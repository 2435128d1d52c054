"""host_resolved_rows_pct.reads: the rows resolved in Python, over
max_taxa on the device (host_resolved_rows of the output.finalize spans),
over the reads classified times the thresholds (%)."""

from portbench.pbcore.spans import reads, recorded, total


def read(context):
    found, n, thresholds = recorded(context, ("output.finalize",)), reads(context), context.get("thresholds")
    if not found or not n or not thresholds:
        return None
    return 100.0 * total(found, "host_resolved_rows") / (n * thresholds)
