"""Cases of the scan's second pass shared by its twin's tests
(test_torch_scan_segments.py) and its kernel's (test_torch_gpu.py)."""

import torch


def hand_made_summaries():
    """(minimizer [2, 1024, 2], distinct, summary [2, 8, 4]) whose stitch
    clears distinct[0, 900] with two limbs, and distinct[1, 400] too when
    only the lo64 limb is compared (a narrow m)."""
    b, L, nseg = 2, 1024, 8
    minimizer = torch.zeros((b, L, 2), dtype=torch.int64)
    distinct = torch.ones((b, L), dtype=torch.bool)
    summary = torch.zeros((b, nseg, 4), dtype=torch.int64)
    summary[:, :, 1] = -1

    def segment(r, j, has, first=-1, last=(0, 0)):
        summary[r, j] = torch.tensor([has, -1 if first < 0 else r * L + first, *last])

    minimizer[0, 700] = torch.tensor([3, 9])
    segment(0, 1, 1, last=(3, 9))
    segment(0, 2, 1, last=(3, 8))  # the nearest holder: lo differs, nothing cleared
    segment(0, 5, 1, first=700, last=(1, 1))
    minimizer[0, 900] = torch.tensor([1, 1])
    segment(0, 7, 1, first=900)  # walks over segment 6 back to 5: equal, cleared
    segment(1, 0, 1, first=10, last=(2, 2))  # a row's first segment: row 0 ended on (0, 0), ignored
    minimizer[1, 400] = torch.tensor([7, 2])
    segment(1, 3, 1, first=400)  # segment 0's (2, 2): lo64 equal, hi64 not
    return minimizer, distinct, summary
