"""Build and load the hand-written CUDA kernels.

Each source in ``csrc/`` has a plain C interface and is compiled by ``nvcc``
into its own shared library on first use, then loaded with ``ctypes``:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -Xptxas=-v -o <lib>.so csrc/<name>.cu

Libraries land in ``build/repro_torch_kernels/`` at the repository root,
named by a digest of the source, the shared headers (``csrc/*.cuh``) and
the flags, so an edited source or header rebuilds and an unchanged one is
reused.  :func:`build_all` starts one ``nvcc`` per
source at once and waits for all of them.  Both it and :func:`load` hold
one process-wide lock, so threads that ask for a library at once (a
background solver build beside the serving thread) build it once, and
each compiler writes to a temporary name of its own process and thread.  The compiler's ``-Xptxas=-v``
report (registers, shared memory, spills) is kept beside each library as
``<lib>.log``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, Optional

__all__ = ["SOURCES", "BUILD_DIR", "NVCC_FLAGS", "build_all", "load",
           "library_path"]

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = {"sptrsv_level": "sptrsv_level.cu", "sptrsv_fused": "sptrsv_fused.cu",
           "spmv_ell": "spmv_ell.cu", "trsm_block": "trsm_block.cu",
           "flash_attn": "flash_attn.cu"}
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_LOADED: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.RLock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built "
                       "(needs the CUDA toolkit on PATH or /usr/local/cuda)")


def library_path(name: str) -> Path:
    """Where the library of kernel source ``name`` is (or will be) built."""
    src = (CSRC / SOURCES[name]).read_bytes()
    src += b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha1(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build_all(names: Optional[Iterable[str]] = None) -> Dict[str, Path]:
    """Compile every missing library among ``names`` (default: all sources)
    with one ``nvcc`` process each, all running together.  Raises
    ``RuntimeError`` with the compiler's output if any build fails."""
    with _LOCK:
        return _build_all(list(SOURCES if names is None else names))


def _build_all(names) -> Dict[str, Path]:
    paths = {name: library_path(name) for name in names}
    todo = [name for name in names if not paths[name].exists()]
    if todo:
        nvcc = _nvcc()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        procs = {}
        for name in todo:
            tmp = paths[name].with_suffix(
                f".{os.getpid()}-{threading.get_ident()}.tmp")
            procs[name] = (tmp, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / SOURCES[name])],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        failed = []
        for name, (tmp, proc) in procs.items():
            out, _ = proc.communicate()
            paths[name].with_suffix(".log").write_text(out)
            if proc.returncode != 0:
                failed.append(f"{name} (rc={proc.returncode}):\n{out}")
                tmp.unlink(missing_ok=True)
            else:
                os.replace(tmp, paths[name])
        if failed:
            raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return paths


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel source ``name``, built on first use."""
    with _LOCK:
        if name not in _LOADED:
            path = build_all([name])[name]
            _LOADED[name] = ctypes.CDLL(str(path))
        return _LOADED[name]
