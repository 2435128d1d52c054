"""Ranks of a multi-process classify for the tests (test_torch_multihost_procs.py
on the CPU, the gpu-marked cases of test_torch_gpu.py on the card): `spawn`
starts `world` processes with torch.multiprocessing, each runs `run_rank`,
which joins the group, classifies its share of the reads through
MultiHostRingClassifier and writes what it saw to a JSON file. Imports no
JAX, so that a spawned rank starts quickly."""

import json
import os
import time

import numpy as np
import torch

#: seconds a spawned group may take before the test fails
TIMEOUT = 180


def run_rank(rank, spec):
    """One rank: initialize (spec: url, world, device, devices, backend),
    classify_and_write_stream of spec["reads"] ([(codes, lengths, titles)]
    chunks) against spec["index"] into spec["out"] through spec's mh_probe
    (if any), then the collectives of one process: allgather_objects and
    report_counts_across_hosts."""
    torch.set_num_threads(1)
    from slacken_tpu_torch import native
    from slacken_tpu_torch.classify import ClassifyParams
    from slacken_tpu_torch.ops import cuda_kernels
    from slacken_tpu_torch.parallel import multihost

    ctx = multihost.initialize(spec["url"], spec["world"], rank, spec["device"], spec["devices"], spec["backend"])
    try:
        cls = multihost.MultiHostRingClassifier(spec["index"], ctx, mh_probe=spec.get("mh_probe"))
        chunks = [native.PackedReads(*c) for c in spec["reads"]]
        cpar = ClassifyParams(thresholds=spec["thresholds"], per_read_output=spec["per_read"])
        before = dict(cuda_kernels.LAUNCHES)
        samples = cls.classify_and_write_stream(lambda: iter(chunks), spec["out"], cpar, spec["rows"])
        seen = {
            "samples": {str(t): s for t, s in samples.items()},
            "lockstep": cls.lockstep,
            "padding": cls.padding_dispatches,
            "p2p": cls.p2p_bytes,
            "launched": {k: v - before[k] for k, v in cuda_kernels.LAUNCHES.items() if v != before[k]},
            "backend": ctx.backend,
            "mesh": [str(d) for d in ctx.mesh],
            "gathered": multihost.allgather_objects({"rank": rank}),
            "counts": multihost.report_counts_across_hosts(np.arange(5) * (rank + 1)).tolist(),
        }
    finally:
        multihost.shutdown()
    with open(spec["report"] % rank, "w") as f:
        json.dump(seen, f)


def spawn(world, spec):
    """run_rank in `world` spawned processes; raises if a rank fails or the
    group outlasts TIMEOUT. Returns the ranks' reports."""
    import torch.multiprocessing as mp

    os.environ.setdefault("OMP_NUM_THREADS", "1")
    procs = mp.start_processes(run_rank, args=(dict(spec, world=world),), nprocs=world, join=False,
                               start_method="spawn")
    t0 = time.monotonic()
    try:
        while not procs.join(timeout=2):
            if time.monotonic() - t0 > TIMEOUT:
                raise TimeoutError(f"{world} ranks did not finish in {TIMEOUT} s")
    finally:
        for p in procs.processes:
            if p.is_alive():
                p.kill()
    out = []
    for r in range(world):
        with open(spec["report"] % r) as f:
            out.append(json.load(f))
    return out


def chunks_of(reads):
    """native.PackedReads chunks as picklable (codes, lengths, titles)."""
    return [(np.asarray(p.codes), np.asarray(p.lengths), list(p.titles)) for p in reads]
