"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled on first
use, never at import, with

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared -Xcompiler -fPIC

into ``build/mica_tpu_torch/<name>-<hash>.so`` at the repository root (the
hash covers the sources and flags, so an edited source never loads a stale
library; ``csrc/*.cuh`` headers are hashed into every source's).
``conv3d_stats``, ``depthwise3``, ``depthwise3_grads`` and ``stem9`` add
``-Xptxas -v``: their registers, shared memory and spills per kernel are
kept in ``logs``.  The library is loaded with ``ctypes``; callers pass pointers
from ``Tensor.data_ptr()`` and the current stream as Python ints.
The device facts the kernels' plans share (``SMEM_MAX``, ``sm_count``)
live here too.

Every C entry launches on the calling thread's current device, on the
stream the wrapper passes (``torch.cuda.current_stream(x.device)``), and
K1, K3, K7 and K8 set their shared-memory attribute once a process: so a
process drives one card, its current device.  Under a process group that
is the rank's own card, which ``parallel.distributed.initialize`` makes
current before any launch.  A tensor on another card should make the
launch fail, its stream being that card's.  (Checked by review only: the
machine that runs the card tests has one card.)
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Callable, Dict, Iterable, Tuple

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "mica_tpu_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-lineinfo"]
EXTRA_FLAGS = {"conv3d_stats": ["-Xptxas", "-v"], "depthwise3": ["-Xptxas", "-v"],
               "depthwise3_grads": ["-Xptxas", "-v"], "stem9": ["-Xptxas", "-v"]}
SOURCES = ("conv3d_stats", "depthwise3", "depthwise3_grads", "stem9", "window_copy",
           "scale2")

SMEM_MAX = 232448   # shared memory a block can use on the H100 (227 KB)

_libs: Dict[str, ctypes.CDLL] = {}
logs: Dict[str, str] = {}   # compiler output of each source built by this process


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels build only where "
                       "the CUDA toolkit is installed")


def _lib_path(name: str) -> Path:
    h = hashlib.sha1(" ".join(NVCC_FLAGS + EXTRA_FLAGS.get(name, [])).encode())
    for src in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(src.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:12]}.so"


def build(names: Iterable[str] = SOURCES) -> Dict[str, float]:
    """Compile every listed source that has no current library, one
    ``nvcc`` per source, all started together.  Returns seconds per
    source (0 where the library was already built).  Raises with the
    compiler's output if a build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.time()
    for name in names:
        out = _lib_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, *EXTRA_FLAGS.get(name, []), "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    seconds = {name: 0.0 for name in names}
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        seconds[name] = time.time() - t0
        logs[name] = log
        if proc.returncode != 0:
            failed.append(f"--- nvcc {name}.cu (exit {proc.returncode})\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return seconds


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed."""
    lib = _libs.get(name)
    if lib is None:
        path = _lib_path(name)
        if not path.exists():
            build([name])
        lib = ctypes.CDLL(str(path))
        _libs[name] = lib
    return lib


_functions: Dict[Tuple[str, str], Callable] = {}


def function(lib: str, name: str, argtypes: list):
    """A C function of ``csrc/<lib>.cu`` with its argument types declared
    (pointers and the stream as ``c_void_p``) and an int error code, looked
    up and declared on the first call only (a wrapper's host time matters
    where its kernel is short).  It launches on the current device (see
    the module's docstring)."""
    fn = _functions.get((lib, name))
    if fn is None:
        fn = getattr(load(lib), name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _functions[lib, name] = fn
    return fn


def check(err: int, what: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


_sm_counts: Dict[int, int] = {}


def sm_count(device: torch.device) -> int:
    """The number of SMs of a CUDA device, read once."""
    idx = device.index if device.index is not None else torch.cuda.current_device()
    if idx not in _sm_counts:
        _sm_counts[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return _sm_counts[idx]
