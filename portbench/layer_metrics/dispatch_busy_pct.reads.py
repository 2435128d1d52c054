"""dispatch_busy_pct.reads: the classifier's dispatch spans, each with its
padding, ambiguity scan, 2-bit packing and launch (copies to the device,
kernels, copies back queued), over the traced stretch (%)."""

from portbench.pbcore.spans import busy_pct


def read(context):
    return busy_pct(context, ("dispatch",))
