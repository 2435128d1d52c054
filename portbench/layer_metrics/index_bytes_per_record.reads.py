"""index_bytes_per_record.reads: the bytes of the arrays that the classifier's
probe reads on the device (a slot table, or keys and taxa, with its
directory and codes) per record of the index, from the counts of its
dispatch spans (index_bytes over index_records, B/record). None on a
program whose dispatch spans do not count them."""

from portbench.pbcore.spans import recorded, total


def read(context):
    found = recorded(context, ("dispatch",))
    records = total(found, "index_records")
    return total(found, "index_bytes") / records if records else None
