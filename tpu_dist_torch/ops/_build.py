"""Build the port's CUDA sources with ``nvcc`` and load them with ``ctypes``.

Each source under ``tpu_dist_torch/csrc/`` exposes a plain C interface and
is compiled, at its first use in a process, into a shared library under
``tpu_dist_torch/_build/`` (listed in ``.gitignore``), named by a hash of
the source and the flags: an edited source builds anew, an unchanged one
loads the library already built. Nothing here runs at import time.
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

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

#: ``sm_90a`` (not ``sm_90``): the Hopper-only instructions (wgmma,
#: setmaxnreg) exist for that target alone. ``-Xptxas=-v`` keeps the
#: registers/shared-memory/spill report in the build log.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}
#: source name -> {"seconds": build wall time, "log": nvcc's stderr};
#: empty for a library found already built.
build_info: dict[str, dict] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    for cand in (os.path.join(home, "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin and "
        "PATH): the port's CUDA kernels are built from source at first use")


def load(source: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<source>``, building it if needed."""
    src = CSRC / source
    digest = hashlib.sha256(
        src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"{src.stem}-{digest}.so"
    with _lock:
        lib = _loaded.get(source)
        if lib is not None:
            return lib
        if not out.exists():
            BUILD_DIR.mkdir(exist_ok=True)
            tmp = BUILD_DIR / f"{src.stem}-{digest}.{os.getpid()}.tmp.so"
            t0 = time.monotonic()
            proc = subprocess.run(
                [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                capture_output=True, text=True)
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                raise RuntimeError(
                    f"nvcc failed on {src} (exit {proc.returncode}):\n"
                    f"{proc.stderr}")
            os.replace(tmp, out)  # atomic: a concurrent loader sees all or none
            build_info[source] = {"seconds": time.monotonic() - t0,
                                  "log": proc.stderr}
        lib = ctypes.CDLL(str(out))
        _loaded[source] = lib
        return lib
