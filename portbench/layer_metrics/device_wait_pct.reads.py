"""device_wait_pct.reads: the host blocked on the device chain of classify:
the harvest's wait for a batch's event (harvest.wait) and its synchronous
fetch of rows over max_taxa or the run cap (harvest.overflow), over the
traced stretch (%)."""

from portbench.pbcore.spans import busy_pct


def read(context):
    return busy_pct(context, ("harvest.wait", "harvest.overflow"))
