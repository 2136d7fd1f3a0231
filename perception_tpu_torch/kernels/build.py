"""Build, load and count the hand-written CUDA kernels.

The kernels of the scoring path live in `perception_tpu_torch/csrc/` as
CUDA C++ with a plain C interface. On first use they are compiled by
`nvcc` for `sm_90a` (one `nvcc` per source, all in parallel) and linked
into one shared library under `build/perception_tpu_torch/` (next to the
package), named by a hash of the sources, their headers and the flags, and
loaded with ctypes. Nothing here runs at import time: the CPU tests import
every module of the package on machines without `nvcc`.

Every wrapper counts what it ran: `LAUNCHES[name]` when it launched its kernel
on a CUDA tensor, `TWIN_CALLS[name]` when a CPU tensor sent it to the plain
PyTorch twin.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import time
from collections import Counter
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
SOURCES = ("raster_direct.cu", "raster_keys.cu", "raster_bin.cu",
           "icp_fused.cu", "cost_fused.cu", "cost_fused_color.cu", "knn.cu")
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "perception_tpu_torch"
# --fmad=false: no contraction of a*b+c into FMAs, so each kernel rounds
# exactly where its PyTorch twin does (the raster keys and the ICP
# association compare bit-for-bit with the twins on the card).
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH_FLAGS, "-std=c++17", "-O3", "--fmad=false",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

LAUNCHES: Counter = Counter()
TWIN_CALLS: Counter = Counter()

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C signatures of csrc/*.cu; every function returns cudaGetLastError().
_SIGNATURES = {
    "pt_raster_direct": (_P, _I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P,
                         _P),
    "pt_raster_keys": (_P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P),
    "pt_keys_setup": (_P, _I, _P, _P, _P, _I, _I, _I, _P, _P, _P),
    "pt_raster_bin": (_P, _I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                      _I, _I, _P, _P),
    "pt_icp_fused": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _F, _I, _F, _F,
                     _F, _I, _F, _F, _F, _F, _P, _P),
    "pt_cost_fused": (_P, _P, _P, _I, _I, _I, _F, _P, _P),
    "pt_cost_fused_color": (_P, _P, _P, _P, _P, _I, _I, _I, _F, _F, _P, _P),
    "pt_cost_fused_color_tri": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                                _F, _F, _P, _P),
    "pt_nn1_batch": (_P, _P, _I, _I, _I, _P, _P, _P),
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
build_seconds: float | None = None   # wall time of this process's build/load
build_log: str = ""                  # nvcc's output (-Xptxas -v register use)


def reset_counts() -> None:
    LAUNCHES.clear()
    TWIN_CALLS.clear()


def find_nvcc() -> str:
    """nvcc from CUDA_HOME, then PyTorch's CUDA_HOME, then /usr/local/cuda."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME:
        candidates.append(Path(CUDA_HOME) / "bin" / "nvcc")
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file():
            return str(c)
    raise RuntimeError(
        "nvcc not found (looked at: " + ", ".join(map(str, candidates)) + ")")


def _source_hash() -> str:
    """The library's name: a hash of the flags, the sources and the headers
    they include (csrc/*.cuh)."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted(p.name for p in CSRC.glob("*.cuh"))
    for name in (*SOURCES, *headers):
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def library() -> ctypes.CDLL:
    """Build (once per source hash) and load the kernel library."""
    global _lib, build_seconds, build_log
    with _lock:
        if _lib is not None:
            return _lib
        t0 = time.perf_counter()
        path = BUILD_DIR / f"libpt_kernels_{_source_hash()}.so"
        if not path.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = path.with_suffix(f".{os.getpid()}.tmp")
            nvcc = find_nvcc()
            objs = [tmp.with_name(f"{tmp.name}.{s}.o") for s in SOURCES]
            procs = [(cmd, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))
                for cmd in ([nvcc, *NVCC_FLAGS, "-c", str(CSRC / s), "-o",
                             str(o)] for s, o in zip(SOURCES, objs))]
            logs, failed = [], []
            for cmd, proc in procs:
                logs.append(proc.communicate()[0])
                if proc.returncode != 0:
                    failed.append(" ".join(cmd))
            link = [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp),
                    *map(str, objs)]
            if not failed:
                proc = subprocess.run(link, capture_output=True, text=True)
                logs.append(proc.stdout + proc.stderr)
                if proc.returncode != 0:
                    failed.append(" ".join(link))
            build_log = "".join(logs)
            for o in objs:
                o.unlink(missing_ok=True)
            if failed:
                raise RuntimeError("nvcc failed: " + "; ".join(failed) + "\n"
                                   + build_log)
            (BUILD_DIR / "build.log").write_text(build_log)
            os.replace(tmp, path)
        lib = ctypes.CDLL(str(path))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
        _lib = lib
        build_seconds = time.perf_counter() - t0
        return _lib


def launch(name: str, *args) -> None:
    """Call one C entry point on PyTorch's current stream; raise on a CUDA
    error code, count the launch otherwise."""
    fn = getattr(library(), name)
    stream = torch.cuda.current_stream().cuda_stream
    err = fn(*args, ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err}")
    LAUNCHES[name.removeprefix("pt_")] += 1


def ptr(t: torch.Tensor | None) -> ctypes.c_void_p:
    """A tensor's device address (NULL for None)."""
    return ctypes.c_void_p(None if t is None else t.data_ptr())


def check(t: torch.Tensor, name: str, dtype: torch.dtype, shape: tuple,
          device: torch.device) -> None:
    """Raise unless `t` has the dtype, shape (None = any), device and
    contiguity a kernel takes."""
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if t.dim() != len(shape) or any(
            s is not None and s != d for s, d in zip(shape, t.shape)):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")
