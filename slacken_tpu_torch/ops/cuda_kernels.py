"""Build, load and launch the hand-written CUDA kernels (ops/kernels/*.cu).

The sources compile at first use with nvcc for sm_90a into one shared
library with a plain C interface, bound through ctypes (no PyTorch headers,
so a build takes seconds). The library's file name carries a hash of the
sources, so a stale binary is never loaded. Kernels launch on PyTorch's
current stream and allocate nothing: the wrappers allocate outputs with
torch.empty, check every input, and raise on any launch error.

`LAUNCHES` counts kernel launches per kernel; a wrapper adds one exactly
where it launches, so a run can show that its main path went through the
kernels.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import time
from typing import Dict, Optional

import torch

from .lookup import PROBE_BLOCK
from .minimizers import space_mask_int

_HERE = os.path.dirname(os.path.abspath(__file__))
SOURCES = sorted(glob.glob(os.path.join(_HERE, "kernels", "*.cu")))
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")
NVCC_FLAGS = [
    "-O3", "-std=c++17", "-gencode", "arch=compute_90a,code=sm_90a",
    "-shared", "-Xcompiler", "-fPIC",
]

LAUNCHES: Dict[str, int] = {"scan": 0, "probe": 0}

_lib = None
#: (seconds, compiler output) of the build this process ran, if any
build_info: Optional[tuple] = None


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return path


def library_path() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in SOURCES:
        with open(src, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"libstpu_kernels_{h.hexdigest()[:16]}.so")


def build(verbose: bool = False) -> str:
    """Compile the kernels unless this exact source set is already built.
    verbose adds -Xptxas -v (registers, shared memory, spills per kernel) to
    the compiler output kept in `build_info`."""
    global build_info
    path = library_path()
    if os.path.exists(path) and not verbose:
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
           "-o", tmp, *SOURCES]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}):\n{proc.stdout}\n{proc.stderr}"
        )
    os.replace(tmp, path)
    build_info = (time.perf_counter() - t0, proc.stdout + proc.stderr)
    return path


def _load():
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(build())
    p, i32, i64, u64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_ulonglong
    lib.stpu_scan.argtypes = [p, p, i64, i32, i32, i32, i32, u64, u64, p, p, p, p, p]
    lib.stpu_scan.restype = i32
    lib.stpu_probe.argtypes = [p, p, i64, p, i64, p, i64, p, p]
    lib.stpu_probe.restype = i32
    _lib = lib
    return lib


def _check(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {rc}")


def _require(t: torch.Tensor, what: str, dtype: torch.dtype, ndim: int) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{what} must be a CUDA tensor, got {t.device}")
    if t.dtype != dtype or t.dim() != ndim or not t.is_contiguous():
        raise ValueError(
            f"{what} must be a contiguous {ndim}-d {dtype} tensor, got "
            f"{t.dtype} {tuple(t.shape)} contiguous={t.is_contiguous()}"
        )


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def window_minimizers_cuda(packed: torch.Tensor, valid: torch.Tensor, params):
    """Fused unpack + minimizer scan (kernels/scan.cu) over pack_2bit's
    [B, L/4] codes and [B, L/8] validity bits. Returns
    (minimizer int64 [B, L], valid, span_start, distinct bool [B, L])."""
    _require(packed, "packed", torch.uint8, 2)
    _require(valid, "valid", torch.uint8, 2)
    b, l4 = packed.shape
    L = 4 * l4
    if tuple(valid.shape) != (b, L // 8) or L % 8:
        raise ValueError(f"valid must be [{b}, {L // 8}], got {tuple(valid.shape)}")
    if params.m > 31 or params.k < params.m:
        raise ValueError(f"the scan kernel takes m <= 31 <= k, got k={params.k} m={params.m}")
    lib = _load()
    mn = torch.empty((b, L), dtype=torch.int64, device=packed.device)
    flags = torch.empty((3, b, L), dtype=torch.uint8, device=packed.device)
    mask = (1 << (2 * params.m)) - 1
    rc = lib.stpu_scan(
        packed.data_ptr(), valid.data_ptr(), b, L, params.k, params.m,
        int(bool(params.canonical)), params.toggle_mask & mask,
        space_mask_int(params.m, params.spaces), mn.data_ptr(),
        flags[0].data_ptr(), flags[1].data_ptr(), flags[2].data_ptr(),
        _stream(packed),
    )
    _check(rc, "scan")
    LAUNCHES["scan"] += 1
    f = flags.view(torch.bool)
    return mn, f[0], f[1], f[2]


def lookup_taxa_fence_cuda(
    keys: torch.Tensor, taxa: torch.Tensor, fence: torch.Tensor, queries: torch.Tensor
) -> torch.Tensor:
    """Exact-match probe (kernels/probe.cu): int32 taxon per int64 query, 0
    on a miss. keys sorted int64 [N], taxa int32 [N], fence = keys[::128]
    (lookup.build_fence)."""
    _require(keys, "keys", torch.int64, 1)
    _require(taxa, "taxa", torch.int32, 1)
    _require(fence, "fence", torch.int64, 1)
    _require(queries, "queries", torch.int64, 1)
    n = keys.shape[0]
    if taxa.shape[0] != n or fence.shape[0] != -(-n // PROBE_BLOCK):
        raise ValueError(
            f"taxa [{taxa.shape[0]}] and fence [{fence.shape[0]}] do not fit {n} keys"
        )
    out = torch.empty(queries.shape[0], dtype=torch.int32, device=queries.device)
    if n == 0:  # an empty index: every query misses
        return out.zero_()
    lib = _load()
    rc = lib.stpu_probe(
        keys.data_ptr(), taxa.data_ptr(), n, fence.data_ptr(), fence.shape[0],
        queries.data_ptr(), queries.shape[0], out.data_ptr(), _stream(queries),
    )
    _check(rc, "probe")
    LAUNCHES["probe"] += 1
    return out
