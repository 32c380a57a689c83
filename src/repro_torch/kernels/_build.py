"""Build and load the port's CUDA kernels (no counterpart in the reference).

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by ``nvcc`` into
its own shared library, loaded with ``ctypes``::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -Xptxas -v -o build/repro_torch/<name>-<hash>.so csrc/<name>.cu

The library name carries a hash of the source, of the ``csrc/`` headers it
includes (``#include "<header>"``) and of the flags, so an edited source or
header rebuilds and an unchanged one loads what an earlier run built.
Nothing is built when a module is imported: the first CUDA launch of a kernel
builds it, and ``build_all`` builds every source at once, one ``nvcc`` per
source, all started together.  ptxas' register and shared-memory report lands
next to each library as ``<name>-<hash>.log``.  ``check_operand`` is the one
operand check every kernel wrapper makes before a launch; ``tickets`` hands
out the zeroed words the kernels' last-CTA folds count arrivals on.
``csrc_constants`` reads a source's ``constexpr int`` literals, so that a
wrapper sizes its launches from the constants the kernel is compiled with.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Callable, Dict, Iterable, Optional, Tuple

__all__ = ["SOURCES", "CSRC", "BUILD_DIR", "build_all", "build_log", "check_operand",
           "csrc_constants", "load", "tickets"]

CSRC = Path(__file__).resolve().parent.parent / "csrc"
# <repo>/build/repro_torch (this file is <repo>/src/repro_torch/kernels/_build.py)
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
SOURCES = ("coo_spmv", "fused_ppr", "topk_select", "fixed_matmul", "flash_attention")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
_tickets: Dict[Tuple[str, str, int], object] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (looked in $CUDA_HOME/bin, "
                           "/usr/local/cuda/bin and PATH); the CUDA kernels "
                           "need the CUDA toolkit to build")
    return found


_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)
_CONSTEXPR = re.compile(r"^\s*constexpr\s+int\s+(\w+)\s*=\s*(\d+)\s*;", re.MULTILINE)


def csrc_constants(filename: str) -> Dict[str, int]:
    """The ``constexpr int <name> = <literal>;`` constants of ``csrc/<filename>``
    (read from the text: nothing is built)."""
    text = (CSRC / filename).read_text()
    return {name: int(value) for name, value in _CONSTEXPR.findall(text)}


def _target(name: str) -> Tuple[Path, Path]:
    src = CSRC / f"{name}.cu"
    text = src.read_bytes()
    h = hashlib.sha256(text)
    for header in sorted(set(_INCLUDE.findall(text))):
        h.update((CSRC / header.decode()).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return src, BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def _start(name: str) -> Optional[Tuple[subprocess.Popen, Path, Path]]:
    src, so = _target(name)
    if so.is_file():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp.so")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    return proc, tmp, so


def _finish(name: str, job: Tuple[subprocess.Popen, Path, Path]) -> None:
    proc, tmp, so = job
    out, _ = proc.communicate()
    so.with_suffix(".log").write_text(out)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed on csrc/{name}.cu "
                           f"(exit {proc.returncode}):\n{out}")
    os.replace(tmp, so)          # atomic: a reader never sees half a library


def build_all(names: Iterable[str] = SOURCES) -> Dict[str, Path]:
    """Build every listed source in parallel; returns name → library path."""
    names = tuple(names)
    with _lock:
        jobs = {n: _start(n) for n in names}
        try:
            for n, job in jobs.items():
                if job is not None:
                    _finish(n, job)
        finally:
            for job in jobs.values():     # never leave an nvcc running
                if job is not None and job[0].poll() is None:
                    job[0].kill()
                    job[0].wait()
    return {n: _target(n)[1] for n in names}


def build_log(name: str) -> str:
    """ptxas' report for ``name`` (registers, shared memory, spills)."""
    log = _target(name)[1].with_suffix(".log")
    return log.read_text() if log.is_file() else ""


def load(name: str, declare: Callable[[ctypes.CDLL], None]) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use.

    ``declare`` sets the ``argtypes``/``restype`` of its entries, once, before
    the library is handed out."""
    lib = _libs.get(name)
    if lib is None:
        so = build_all((name,))[name]
        with _lock:
            lib = _libs.get(name)
            if lib is None:
                lib = ctypes.CDLL(str(so))
                declare(lib)
                _libs[name] = lib
    return lib


def check_operand(t, name: str, dtype, shape=None, *, dims: Optional[int] = None,
                  align: int = 1) -> None:
    """Raise unless ``t`` is a contiguous CUDA tensor of ``dtype`` whose data
    is ``align``-byte aligned, of ``shape`` or of ``dims`` dimensions when given."""
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got {tuple(t.shape)}")
    if dims is not None and t.dim() != dims:
        raise ValueError(f"{name} must be a {dims}-d tensor, got {t.dim()}-d")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.data_ptr() % align:
        raise ValueError(f"{name} must be {align}-byte aligned")


def tickets(kernel: str, device, stream, n: int):
    """At least ``n`` zeroed int32 words on ``device`` for ``kernel``'s
    last-CTA folds on ``stream``.  Every launch leaves its words at 0 again,
    so a set is zeroed once, when made (or grown), and never per call."""
    import torch

    key = (kernel, str(device), stream.cuda_stream)
    t = _tickets.get(key)
    if t is None or t.numel() < n:
        t = _tickets[key] = torch.zeros(n, dtype=torch.int32, device=device)
    return t
