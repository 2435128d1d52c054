"""padded_rows_pct.reads: the rows of padding among the rows launched, from
the counts of the classifier's dispatch spans (padded_rows over rows, %)."""

from portbench.pbcore.spans import recorded, total


def read(context):
    found = recorded(context, ("dispatch",))
    rows = total(found, "rows")
    return 100.0 * total(found, "padded_rows") / rows if rows else None
