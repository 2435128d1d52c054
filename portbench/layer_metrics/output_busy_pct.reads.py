"""output_busy_pct.reads: the classifier's output work: the per-threshold
finalisation with the host resolver (output.finalize), the per-sample
tallies (output.count), per-read line formatting, writing and closing
(lines.emit, lines.write, lines.close) and the kreports (reports.write),
over the traced stretch (%)."""

from portbench.pbcore.spans import busy_pct


def read(context):
    return busy_pct(context, ("output.finalize", "output.count", "lines.emit", "lines.write", "lines.close",
                              "reports.write"))
