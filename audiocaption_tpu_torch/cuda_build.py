"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by
``nvcc`` for ``sm_90a`` into its own shared library under ``build/kernels/``
at the repository root, then loaded with ``ctypes``.  A library's file
name carries a hash of its sources (the ``.cu`` and every ``.cuh``), so a
changed source is rebuilt and an unchanged one is reused.  The build
runs at first use; :func:`build_all` compiles every kernel at once, one
``nvcc`` process per source, all started together.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Collection, Dict, Iterable, Mapping, Tuple, Union

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "kernels"
KERNELS = ("fused_greedy", "fused_beam", "fused_logmel", "fused_mbconv")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for cand in (os.environ.get("NVCC"), shutil.which("nvcc"),
                 "/usr/local/cuda/bin/nvcc"):
        if cand and Path(cand).exists():
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built with the "
                       "CUDA toolkit's nvcc (set NVCC or put it on PATH)")


def library_path(name: str) -> Path:
    h = hashlib.sha256()
    for src in [CSRC / f"{name}.cu"] + sorted(CSRC.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def build_all(names: Iterable[str] = KERNELS,
              verbose: Union[bool, Collection[str]] = False
              ) -> Dict[str, Path]:
    """Compile every named kernel that is not built yet, in parallel.
    ``verbose`` (all, or the names given) adds ``-Xptxas -v`` and prints
    nvcc's output: registers, shared memory and spills per kernel.
    Raises with nvcc's output if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    todo = {n: library_path(n) for n in names}
    loud = set(todo) if verbose is True else set(verbose or ())
    procs = {}
    for name, out in todo.items():
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS,
               *(["-Xptxas", "-v"] if name in loud else []),
               "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    errors = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {name}.cu:\n{log}")
            continue
        if name in loud and log.strip():
            print(f"[nvcc {name}]\n{log.strip()}")
        tmp.replace(out)
    if errors:
        raise RuntimeError("\n".join(errors))
    return todo


def load(name: str, signatures: Mapping[str, Tuple[list, type]]
         ) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, building it if needed.
    ``signatures`` maps each C function the caller uses to its
    ``(argtypes, restype)``; they are set once, when the library loads."""
    with _lock:
        if name not in _loaded:
            path = library_path(name)
            if not path.exists():
                build_all([name])
            lib = ctypes.CDLL(str(path))
            for fn, (argtypes, restype) in signatures.items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = restype
            _loaded[name] = lib
        return _loaded[name]


def check(err: int, what: str) -> None:
    """Raise if a launch function returned a non-zero cudaError_t."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
