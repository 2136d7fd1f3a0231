"""ctypes bridge to the host mesh loader (`csrc/mesh_loader.cpp`).

The library is compiled with the host C++ compiler (`$CXX`, else `g++`) on
first use into `build/perception_tpu_torch/` next to the package, named by a
hash of the source, and loaded with ctypes. It is host code: mesh parsing and
QEM decimation, the same implementation the JAX package builds
(`perception_tpu/native/loader.py`: its `load_mesh_native`,
`decimate_qem_native` and `native_available` / `qem_available` are
`load_mesh`, `decimate_qem` and `library` here, which raises where those
return False; `load_mesh_native`'s target_faces clustering has no caller
in the repo and is not bound), so both packages decimate a model into the
same triangles.
Without a compiler the functions raise; nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

import numpy as np

from perception_tpu_torch.kernels.build import BUILD_DIR, CSRC

SOURCE = CSRC / "mesh_loader.cpp"
# A compiler that links libstdc++ statically would otherwise export that copy
# and bind half of its calls to the process's own libstdc++ (loaded by torch):
# iostream locale facets then mix the two copies' tables and segfault,
# depending on which facets the process used first. --exclude-libs keeps a
# static runtime private and -Bsymbolic binds the library's references
# inside it; with a shared libstdc++ both change nothing.
CXX_FLAGS = ("-O2", "-std=c++17", "-fPIC", "-shared",
             "-Wl,--exclude-libs,ALL", "-Wl,-Bsymbolic")

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None

_PD = ctypes.POINTER(ctypes.c_double)
_PI64 = ctypes.POINTER(ctypes.c_int64)
_PU8 = ctypes.POINTER(ctypes.c_uint8)
_L = ctypes.c_long


def library() -> ctypes.CDLL:
    """Build (once per source hash) and load the mesh library."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
        h.update(SOURCE.read_bytes())
        path = BUILD_DIR / f"libpt_mesh_{h.hexdigest()[:16]}.so"
        if not path.exists():
            cxx = os.environ.get("CXX") or shutil.which("g++") or "c++"
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = path.with_suffix(f".{os.getpid()}.tmp")
            cmd = [cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"{' '.join(cmd)} failed:\n"
                                   + proc.stdout + proc.stderr)
            os.replace(tmp, path)
        lib = ctypes.CDLL(str(path))
        lib.pt_load_mesh.restype = ctypes.c_int
        lib.pt_load_mesh.argtypes = [
            ctypes.c_char_p, _L, ctypes.POINTER(_PD), ctypes.POINTER(_L),
            ctypes.POINTER(_PI64), ctypes.POINTER(_L), ctypes.POINTER(_PU8),
            ctypes.POINTER(ctypes.c_int)]
        lib.pt_decimate_qem.restype = ctypes.c_int
        lib.pt_decimate_qem.argtypes = [
            _PD, _L, _PI64, _L, _PU8, _L, ctypes.POINTER(_PD),
            ctypes.POINTER(_L), ctypes.POINTER(_PI64), ctypes.POINTER(_L),
            ctypes.POINTER(_PU8), ctypes.POINTER(ctypes.c_int)]
        lib.pt_free.argtypes = [ctypes.c_void_p]
        lib.pt_last_error.restype = ctypes.c_char_p
        _lib = lib
        return _lib


def _take(lib, out_v, n_v, out_f, n_f, out_c, has_c):
    """Copy the library's malloc'd (verts, faces, colors|None) and free them."""
    try:
        verts = np.ctypeslib.as_array(out_v, shape=(n_v.value, 3)).copy()
        faces = np.ctypeslib.as_array(out_f, shape=(n_f.value, 3)).copy()
        colors = (np.ctypeslib.as_array(out_c, shape=(n_v.value, 3)).copy()
                  if has_c.value else None)
    finally:
        lib.pt_free(out_v)
        lib.pt_free(out_f)
        if has_c.value:
            lib.pt_free(out_c)
    return verts, faces, colors


def decimate_qem(verts, faces, colors, target_faces: int):
    """QEM edge-collapse decimation: verts [V,3] f64, faces [F,3] i64,
    colors [V,3] (0..255) | None -> (verts, faces, colors u8 | None)."""
    lib = library()
    verts = np.ascontiguousarray(verts, np.float64)
    faces = np.ascontiguousarray(faces, np.int64)
    cols = (np.ascontiguousarray(np.clip(colors, 0, 255), np.uint8)
            if colors is not None else None)
    out = (_PD(), _L(), _PI64(), _L(), _PU8(), ctypes.c_int())
    rc = lib.pt_decimate_qem(
        verts.ctypes.data_as(_PD), len(verts),
        faces.ctypes.data_as(_PI64), len(faces),
        cols.ctypes.data_as(_PU8) if cols is not None else None,
        target_faces, *(ctypes.byref(o) for o in out))
    if rc != 0:
        raise RuntimeError("QEM decimation failed")
    return _take(lib, *out)


def load_mesh(path: str):
    """Parse a PLY or OBJ file -> (verts [V,3] f64, faces [F,3] i64,
    colors [V,3] u8 | None)."""
    lib = library()
    out = (_PD(), _L(), _PI64(), _L(), _PU8(), ctypes.c_int())
    rc = lib.pt_load_mesh(path.encode(), 0, ctypes.byref(out[0]),
                          ctypes.byref(out[1]), ctypes.byref(out[2]),
                          ctypes.byref(out[3]), ctypes.byref(out[4]),
                          ctypes.byref(out[5]))
    if rc != 0:
        raise RuntimeError(
            f"mesh load failed: {lib.pt_last_error().decode()}")
    return _take(lib, *out)
