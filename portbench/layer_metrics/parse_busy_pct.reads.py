"""parse_busy_pct.reads: the program's own spans of input parsing, the
native FASTQ parse of each chunk (input.parse) and the joining of mates
(input.pair), in the classifier's prefetch thread, over the traced
stretch (%): the inside twin of input_parse_busy_pct.reads."""

from portbench.pbcore.spans import busy_pct


def read(context):
    return busy_pct(context, ("input.parse", "input.pair"))
