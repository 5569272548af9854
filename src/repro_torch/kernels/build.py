"""Build the CUDA kernels at first use and bind them with ctypes.

Every ``csrc/*.cu`` (with the shared ``csrc/*.cuh`` headers) compiles with
``nvcc`` for ``sm_90a`` into one shared library with a plain C interface —
no PyTorch headers, so a build takes seconds.  The sources compile in
parallel (one ``nvcc`` each, all started together) and link into
``build/repro_torch_kernels/<hash>/`` at the repository root, keyed by a
hash of the sources and flags, so a changed source rebuilds and an
unchanged one loads the cached library.

Each C entry point returns ``cudaGetLastError()`` after its launch;
:func:`check` turns a nonzero code into an exception.  Pointers and the
stream go in as ``ctypes.c_void_p`` (a plain int would be cut to 32 bits).

The kernels have no backward: a wrapper writes into a fresh tensor that
autograd knows nothing of.  :func:`refuse_grad` runs in every wrapper
before the kernel route touches the library, and raises where an input
requires grad — an output without a ``grad_fn`` would drop that
gradient silently.  The trainer takes the model's differentiable route
instead (``LM.loss_fn(..., differentiable=True)``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Optional

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_PI64 = ctypes.POINTER(ctypes.c_int64)
# C signature of every entry point: (argtypes), restype is int
SIGNATURES = {
    "nm_spmm_launch": (_P, _P, _P, _P, _I, _I, _I, _I, _P),
    "nm_spmm_decode_launch": (_P, _P, _P, _P, _I, _P, _I, _I, _I, _I, _I, _I,
                              _I, _I, _P),
    "nm_spmm_decode_clusters": (_I, _I, ctypes.POINTER(_I)),
    "paged_attn_launch": (_P, _P, _P, _P, _P, _P, _P, _P,
                          _I, _I, _I, _I, _I, _I, _I, _I, _I,
                          _I, _I, _I, _I, _I, _I, _I, _P),
    "hessian_accum_launch": (_P, _I, _I, _I, _P, _P, _I, _I, _F, _F, _P),
    "hessian_accum_weighted_launch": (_P, _I, _I, _I, _P, _P, _I, _I, _P,
                                      _I, _P, _P),
    "nm_select_launch": (_P, _I, _I, _P, _I, _P, _I, _I, _I, _I, _P),
    "flash_attn_launch": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _PI64, _I,
                          _I, _I, _I, ctypes.POINTER(_I), _P),
}

_LIB: Optional[ctypes.CDLL] = None
_LIB_LOCK = threading.Lock()              # one build, whichever thread asks
_COUNT_LOCK = threading.Lock()
build_seconds: Optional[float] = None     # wall time of this process's build


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "machine with the CUDA toolkit")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted([*CSRC.glob("*.cu"), *CSRC.glob("*.cuh")]):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _build(out_dir: Path) -> Path:
    """Compile every .cu in parallel, link the shared library, and move
    the finished directory into place atomically."""
    nvcc = _nvcc()
    tmp = out_dir.with_name(f"{out_dir.name}.tmp-{os.getpid()}")
    tmp.mkdir(parents=True, exist_ok=True)
    procs = []
    for src in sorted(CSRC.glob("*.cu")):
        obj = tmp / (src.stem + ".o")
        log = open(tmp / (src.stem + ".log"), "w")
        procs.append((src, log, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
            stdout=log, stderr=subprocess.STDOUT)))
    failed = []
    for src, log, proc in procs:
        if proc.wait() != 0:
            failed.append(src.name)
        log.close()
    if failed:
        logs = "\n".join((tmp / (Path(f).stem + ".log")).read_text()
                         for f in failed)
        raise RuntimeError(f"nvcc failed for {failed}:\n{logs}")
    lib = tmp / "librepro_torch_kernels.so"
    subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a",
                    "-shared", "-o", str(lib),
                    *[str(p) for p in sorted(tmp.glob("*.o"))]],
                   check=True, capture_output=True)
    try:
        os.replace(tmp, out_dir)
    except OSError:                      # a concurrent build won the race
        shutil.rmtree(tmp, ignore_errors=True)
    return out_dir / lib.name


def library() -> ctypes.CDLL:
    """The kernels' shared library, built on the first call."""
    global _LIB, build_seconds
    if _LIB is not None:
        return _LIB
    with _LIB_LOCK:
        if _LIB is not None:
            return _LIB
        out_dir = BUILD_ROOT / _digest()
        path = out_dir / "librepro_torch_kernels.so"
        if not path.exists():
            t0 = time.monotonic()
            path = _build(out_dir)
            build_seconds = time.monotonic() - t0
        lib = ctypes.CDLL(str(path))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _LIB = lib
        return lib


def count_launch(wrapper) -> None:
    """Add one to a wrapper's ``launches``, under one lock: the serve
    front end's replica threads launch concurrently, and an unlocked
    ``+= 1`` can lose a count.  (``last_kernel`` / ``last_plan`` stay
    unlocked: with two threads they name whichever launch came last.)"""
    with _COUNT_LOCK:
        wrapper.launches += 1


def ptxas_report() -> str:
    """The compiler's per-kernel register / shared-memory / spill lines
    from the build logs (``-Xptxas -v``)."""
    out_dir = BUILD_ROOT / _digest()
    lines = []
    for log in sorted(out_dir.glob("*.log")):
        lines += [ln.strip() for ln in log.read_text().splitlines()
                  if "registers" in ln or "spill" in ln]
    return "\n".join(lines)


def check(code: int, name: str) -> None:
    if code != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {code}")


def refuse_grad(name: str, *tensors: Optional[torch.Tensor]) -> None:
    """Raise when grad mode is on and an input requires grad: the kernel
    ``name`` would return an output with no ``grad_fn``."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name}: an input requires grad, but the kernel has no "
            "backward — its output would drop the gradient; train through "
            "LM.loss_fn(..., differentiable=True), or call it under "
            "torch.no_grad()")
