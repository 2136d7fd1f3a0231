"""The JAX package's C++ QEM decimator, loaded safely under xdist, as a
session fixture for the port's tests that decimate or load meshes through
the JAX package's native library."""

import fcntl
import importlib
import os
import subprocess
import tempfile
from pathlib import Path

import pytest

BUILD = Path(__file__).resolve().parents[1] / "build"


@pytest.fixture(scope="session")
def jax_native_qem():
    """The JAX package's C++ QEM decimator, loaded in this process.

    Its loader runs `make` in place on first use, and tests/test_native.py
    calls it while being collected, in every xdist worker at once: a worker
    can load another's half-written library, and its loader then falls back
    for the whole session, silently, to the pure-Python QEM, whose decimated
    meshes differ from the C++ QEM's. Here, under a file lock in build/, a
    library that does not load is built again by its Makefile in a scratch
    directory and renamed into place, and the loader is reloaded, so that no
    fallback cached during collection is left; a failed build fails the test
    with make's own output."""
    from perception_tpu.native import loader

    BUILD.mkdir(exist_ok=True)
    with open(BUILD / "jax_native_qem.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        importlib.reload(loader)
        if not (os.path.exists(loader._LIB_PATH) and loader.qem_available()):
            with tempfile.TemporaryDirectory(dir=BUILD) as tmp:
                # VPATH finds the source in the package; -B builds the
                # library here even where a stale one sits beside it.
                proc = subprocess.run(
                    ["make", "-B", "-C", tmp, "-f",
                     os.path.join(loader._DIR, "Makefile"),
                     f"VPATH={loader._DIR}"],
                    capture_output=True, text=True)
                assert proc.returncode == 0, proc.stdout + proc.stderr
                os.replace(os.path.join(tmp, "libperception_mesh.so"),
                           loader._LIB_PATH)
            importlib.reload(loader)
        assert loader.qem_available(), f"{loader._LIB_PATH} does not load"
