"""build_packing_pct: the host's share of the traced builds: the
"fragment source" and "packing" phases of KeyValueIndex.build(trace=True)
(synchronised PhaseTimers spans inside the program), over the builds'
walls on the host's clock (%)."""


def read(context):
    phases, walls = context.get("build_phases"), context.get("build_walls")
    if not phases or not walls or sum(walls) <= 0:
        return None
    host = sum(p.get("fragment source", 0.0) + p.get("packing", 0.0) for p in phases)
    return 100.0 * host / sum(walls)
