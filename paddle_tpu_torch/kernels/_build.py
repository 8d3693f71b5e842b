"""Build the port's CUDA sources into shared libraries and load them.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into
``_build/lib<name>-<hash>.so`` (the hash covers the source, every header of
``csrc/`` (``*.cuh``) and the flags, so an edited source or header rebuilds
and a stale library is never loaded) and bound with ``ctypes``: each source
exposes one plain ``extern "C"`` launcher named like the kernel, so no
PyTorch header is compiled and a build takes seconds. Nothing is built when a module is imported; the first launch
builds what it needs, and ``build_all()`` builds every source that is not
built yet, one ``nvcc`` per source, all started together.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, Sequence

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

# every CUDA source of the port, by kernel name
SOURCES = {"flash_pair_fwd": "flash_pair_fwd.cu",
           "flash_pair_bwd": "flash_pair_bwd.cu",
           "flash_attention_fwd": "flash_attention_fwd.cu",
           "flash_attention_bwd": "flash_attention_bwd.cu",
           "dq_ordered_sum": "dq_sum.cu",
           "dropout_fwd": "dropout.cu",
           "fused_add_dropout_ln_fwd": "fused_residual_fwd.cu",
           "fused_add_dropout_ln_bwd": "fused_residual_bwd.cu"}

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH, else the toolkit's
    conventional install location."""
    home = os.environ.get("CUDA_HOME")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH "
                       "(the port's CUDA kernels are built at first use)")


def _lib_path(name: str) -> Path:
    h = hashlib.sha256((CSRC / SOURCES[name]).read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    digest = h.hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build(name: str) -> dict:
    """Compile source ``name`` with ``nvcc``. Returns ``{"seconds": wall
    time, "log": nvcc's output}``; raises ``RuntimeError`` with the
    compiler's output when the build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, str(CSRC / SOURCES[name])]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, stdout=subprocess.PIPE,
                         stderr=subprocess.STDOUT, text=True)
    if res.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"CUDA build of {name} failed (nvcc exit "
                           f"{res.returncode}):\n{res.stdout}")
    os.replace(tmp, _lib_path(name))     # atomic: never a half-written .so
    return {"seconds": time.perf_counter() - t0, "log": res.stdout}


def build_all() -> Dict[str, dict]:
    """Build every source that is not built yet, one ``nvcc`` per source
    in a thread each, all started together: ``{name: build result}`` for
    what was built. Waits for every build, then raises for the first that
    failed."""
    names = [name for name in SOURCES if not _lib_path(name).exists()]
    with ThreadPoolExecutor(max_workers=max(1, len(names))) as pool:
        futures = {name: pool.submit(build, name) for name in names}
    return {name: f.result() for name, f in futures.items()}


def load(name: str, argtypes: Sequence, restype=ctypes.c_int) -> ctypes.CDLL:
    """The loaded library for kernel ``name``, building it first if needed.
    ``argtypes`` must declare every pointer and the stream as
    ``ctypes.c_void_p`` so no pointer is cut to 32 bits."""
    lib = _loaded.get(name)
    if lib is None:
        path = _lib_path(name)
        if not path.exists():
            build(name)
        lib = ctypes.CDLL(str(path))
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = restype
        _loaded[name] = lib
    return lib
