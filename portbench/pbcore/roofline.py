"""The card's published peaks (NVIDIA H100 SXM data sheet, at the full
700 W power limit; a card set below it reaches less, so the power limit is
written beside every share), and the least time of a count of bytes."""

#: HBM3 bytes a second of one H100 SXM
PEAK_BYTES_PER_S = 3.35e12


def least_seconds(n_bytes: float) -> float:
    """The least time to move n_bytes at the memory rate."""
    return n_bytes / PEAK_BYTES_PER_S
