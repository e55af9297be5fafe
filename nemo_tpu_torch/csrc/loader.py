"""Build the `.cu` sources of this directory with nvcc and load them with ctypes.

Each source `<name>.cu` exposes a plain C interface and is compiled on first
use into `build/lib<name>-<hash>.so` (hash of the source and the flags), for
`sm_90a`:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v -o build/lib<name>-<hash>.so <name>.cu

`build_all()` starts one nvcc per source, all at once, and waits for them.
ptxas's register and shared-memory report goes to `build/<name>.log`.
Nothing is built when this module is imported. `wgmma_tile_product` runs the
unit check of `hopper.cuh` (`hopper_check.cu`).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Sequence

CSRC = Path(__file__).resolve().parent
BUILD = CSRC / "build"
SOURCES = ("relpos_flash", "relpos_flash_bwd", "fused_subsampling", "flash_fwd", "flash_bwd",
           "hopper_check")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return nvcc


def _target(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    h = hashlib.sha1(src.read_bytes())
    for hdr in sorted(CSRC.glob("*.cuh")):
        h.update(hdr.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD / f"lib{name}-{h.hexdigest()[:12]}.so"


def _start(name: str):
    """Start nvcc for one source unless its library is already built;
    returns (process, name, temporary output, final output, log file)."""
    out = _target(name)
    if out.exists():
        return None
    nvcc = _nvcc()
    BUILD.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    log = open(BUILD / f"{name}.log", "w")
    try:
        proc = subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT)
    except OSError:
        log.close()
        raise
    return proc, name, tmp, out, log


def _finish(job) -> None:
    proc, name, tmp, out, log = job
    try:
        rc = proc.wait()
    finally:
        log.close()
    if rc != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu (rc {rc}):\n"
                           + (BUILD / f"{name}.log").read_text()[-4000:])
    os.replace(tmp, out)


def build_all(names: Sequence[str] = SOURCES) -> Dict[str, Path]:
    """Compile every named source in parallel; returns name → library path."""
    jobs = [j for j in (_start(n) for n in names) if j is not None]
    errors = []
    for j in jobs:
        try:
            _finish(j)
        except RuntimeError as e:
            errors.append(str(e))
    if errors:
        raise RuntimeError("\n".join(errors))
    return {n: _target(n) for n in names}


@functools.lru_cache(maxsize=None)
def library(name: str) -> ctypes.CDLL:
    """The loaded kernel library `name`, built first if needed."""
    job = _start(name)
    if job is not None:
        _finish(job)
    return ctypes.CDLL(str(_target(name)))


def check(err: int, what: str) -> None:
    """Raise if a kernel's C entry point returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


A_SOURCES = ("tma", "registers", "threads", "plain")  # hopper_check's areg 0, 1, 2, 3
# the (N, b layout, a source) forms hopper_check takes besides N 64 and 128 with a
# by TMA, registers or threads and b K- or MN-major by TMA: fused_subsampling.cu's,
# and the dh-96 flash kernels' products into dh (N 96, b MN-major, a in registers)
PLAIN_FORMS = ((256, "mn", "tma"), (256, "mn", "plain"), (128, "mn", "plain"),
               (32, "k_plain", "plain"), (96, "mn", "registers"))


def wgmma_tile_product(a, b, b_mn_major: bool, a_source: str, b_plain: bool = False):
    """c [64, N] fp32 = a [64, 64] · b' on the card by one warpgroup: a and b
    bf16 CUDA tensors, four wgmma m64nNk16 steps, the unit check of
    `hopper.cuh`. b is [N, 64] (K-major, c = a b^T) or, with `b_mn_major`,
    [64, N] (MN-major, c = a b), loaded by TMA; with `b_plain`, [N, 64]
    K-major written by the threads with no swizzle (`hopper.cuh:desc_plain`).
    `a_source` says how a reaches wgmma: "tma" (loaded into shared memory by
    TMA), "registers" (as register A fragments), "threads" (stored into
    shared memory by the threads in the 128-byte swizzle, `hopper.cuh:sw128`)
    or "plain" (stored by the threads with no swizzle). N is 64 or 128 for
    the first three sources with b by TMA, and the forms of `PLAIN_FORMS`."""
    import torch

    n = b.shape[1] if b_mn_major else b.shape[0]
    layout = "mn" if b_mn_major else ("k_plain" if b_plain else "k")
    want = (64, n) if b_mn_major else (n, 64)
    classic = n in (64, 128) and not b_plain and a_source in A_SOURCES[:3]
    if (a.shape != (64, 64) or tuple(b.shape) != want
            or not (classic or (n, layout, a_source) in PLAIN_FORMS)
            or a.dtype != torch.bfloat16 or b.dtype != torch.bfloat16
            or not (a.is_cuda and b.is_cuda)):
        raise ValueError("wgmma_tile_product: a [64, 64] and b [N, 64] or [64, N] bf16 on the "
                         "card, N 64 or 128 or a form of PLAIN_FORMS")
    if a_source not in A_SOURCES:
        raise ValueError(f"wgmma_tile_product: a_source is one of {A_SOURCES}")
    a, b = a.contiguous(), b.contiguous()
    c = torch.empty(64, n, dtype=torch.float32, device=a.device)
    fn = library("hopper_check").hopper_check
    fn.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p] * 4
    fn.restype = ctypes.c_int
    tb = 2 if b_plain else int(b_mn_major)
    check(fn(n, tb, A_SOURCES.index(a_source), a.data_ptr(), b.data_ptr(),
             c.data_ptr(), torch.cuda.current_stream(a.device).cuda_stream),
          "wgmma_tile_product")
    return c
