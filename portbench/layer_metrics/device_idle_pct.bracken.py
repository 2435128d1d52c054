"""device_idle_pct.bracken: the device's idle share of the traced stretch,
100 x (1 - the union of kernel and copy intervals over the stretch), from
torch.profiler's trace (%)."""

from portbench.pbcore.trace import idle_pct


def read(context):
    return idle_pct(context.get("reading"))
