"""window_reads_per_s: read pairs of the requests completed in a traced
run's window over the window's time, from its start to the last completion
(reads/s), as the classify traffic counts them (kinds/classify.py,
Traffic.end_to_end). The host's speed moves it by more than any bound
holds, so it is recorded per layer and not held end to end. The profiler
runs over a few requests of the window."""


def read(context):
    return (context.get("window") or {}).get("reads_per_s")
