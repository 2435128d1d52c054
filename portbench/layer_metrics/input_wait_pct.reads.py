"""input_wait_pct.reads: the main thread's waits on the prefetch queue of
parsed chunks (input.wait spans), over the traced stretch (%): the share of
the stretch in which the classifier had nothing to dispatch because the
reader was behind."""

from portbench.pbcore.spans import busy_pct


def read(context):
    return busy_pct(context, ("input.wait",))
