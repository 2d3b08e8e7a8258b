"""The port's native (C++) CIDEr-D scorer, ``FastCiderD``: the JAX
package's ``native.FastCiderD`` API over this package's own copy of
``cider.cc``, scoring the SCST rewards and the validation score.

The shared library is compiled with ``g++`` at first use
into ``build/native/`` at the repository root, never beside the source;
its file name carries a hash of the source and of the compile command, so
a changed source or compiler builds anew and an unchanged one is reused.
A failed build raises with the compiler's output: there is no silent
fallback (``metrics.cider.CiderD`` is the plain version the tests hold
this scorer to).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Dict, List, Tuple

import numpy as np

SOURCE = Path(__file__).resolve().parent / "cider.cc"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "native"
CXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}


def library_path(compiler: str = "g++") -> Path:
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join([compiler, *CXX_FLAGS]).encode())
    return BUILD_DIR / f"libcider_{h.hexdigest()[:16]}.so"


def load_library(compiler: str = "g++") -> ctypes.CDLL:
    """The scorer's library, built first if needed by ``compiler``;
    raises ``RuntimeError`` naming the compiler's error when the build
    fails."""
    out = library_path(compiler)
    with _lock:
        if str(out) in _loaded:
            return _loaded[str(out)]
        if not out.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [compiler, *CXX_FLAGS, str(SOURCE), "-o", str(tmp)]
            try:
                proc = subprocess.run(cmd, capture_output=True, text=True,
                                      timeout=300)
            except OSError as e:
                raise RuntimeError(f"building {SOURCE.name} failed: "
                                   f"{' '.join(cmd)}: {e}") from e
            if proc.returncode != 0:
                raise RuntimeError(f"building {SOURCE.name} failed: "
                                   f"{' '.join(cmd)}\n{proc.stdout}"
                                   f"{proc.stderr}")
            tmp.replace(out)
        lib = ctypes.CDLL(str(out))
        lib.cider_d_score.argtypes = [
            ctypes.POINTER(ctypes.c_int32),   # hyp tokens
            ctypes.POINTER(ctypes.c_int64),   # hyp offsets
            ctypes.POINTER(ctypes.c_int32),   # ref tokens
            ctypes.POINTER(ctypes.c_int64),   # ref offsets
            ctypes.POINTER(ctypes.c_int64),   # ref doc offsets
            ctypes.c_int64,                   # n docs
            ctypes.c_double,                  # sigma
            ctypes.POINTER(ctypes.c_double),  # out
        ]
        lib.cider_d_score.restype = None
        _loaded[str(out)] = lib
        return lib


def _flatten(sents: List[List[int]]) -> Tuple[np.ndarray, np.ndarray]:
    off = np.zeros(len(sents) + 1, np.int64)
    for i, s in enumerate(sents):
        off[i + 1] = off[i] + len(s)
    toks = np.fromiter((t for s in sents for t in s), np.int32,
                       count=int(off[-1]))
    return toks, off


class FastCiderD:
    """pycocoevalcap-style API: ``compute_score(gts, res)`` -> (corpus
    mean, per-key array in ``res``'s key order), CIDEr-D with n = 4.
    The document frequencies come from the references given, as
    ``metrics.cider.CiderD`` computes them on its first call."""

    def __init__(self, n: int = 4, sigma: float = 6.0,
                 compiler: str = "g++"):
        if n != 4:
            raise ValueError("the native scorer is specialised to n = 4")
        self.sigma = sigma
        self.compiler = compiler
        self._word2id: Dict[str, int] = {}

    def _ids(self, sentence: str) -> List[int]:
        out = []
        for w in sentence.split():
            if w not in self._word2id:
                self._word2id[w] = len(self._word2id)
            out.append(self._word2id[w])
        return out

    def compute_score(self, key2refs: Dict[str, List[str]],
                      key2pred: Dict[str, List[str]]
                      ) -> Tuple[float, np.ndarray]:
        lib = load_library(self.compiler)
        keys = list(key2pred.keys())
        hyps = [self._ids(key2pred[k][0]) for k in keys]
        refs: List[List[int]] = []
        ref_doc_off = np.zeros(len(keys) + 1, np.int64)
        for i, k in enumerate(keys):
            refs.extend(self._ids(r) for r in key2refs[k])
            ref_doc_off[i + 1] = len(refs)
        hyp_toks, hyp_off = _flatten(hyps)
        ref_toks, ref_off = _flatten(refs)
        out = np.zeros(len(keys), np.float64)

        def ptr(a, t):
            return a.ctypes.data_as(ctypes.POINTER(t))
        lib.cider_d_score(
            ptr(hyp_toks, ctypes.c_int32), ptr(hyp_off, ctypes.c_int64),
            ptr(ref_toks, ctypes.c_int32), ptr(ref_off, ctypes.c_int64),
            ptr(ref_doc_off, ctypes.c_int64), len(keys), float(self.sigma),
            ptr(out, ctypes.c_double))
        return float(out.mean()) if len(out) else 0.0, out
