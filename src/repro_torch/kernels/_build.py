"""Build the CUDA kernels with nvcc and bind them with ctypes.

At the first CUDA call, every ``repro_torch/csrc/*.cu`` is compiled into its
own shared library with a plain C interface, one ``nvcc`` process per source,
all started together::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -o build/torch_kernels/<hash>/<name>.so csrc/<name>.cu

``<hash>`` is a digest of every source under ``csrc/`` and the flags, so a
changed source builds anew and an unchanged one is loaded as it is.  The
build directory sits at the repository root and is listed in ``.gitignore``.
A failed build raises with nvcc's output; nothing falls back.

Each C entry returns ``cudaGetLastError()`` after its launch;
``check_launch`` raises on a code other than 0.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Sequence

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def sources() -> Dict[str, Path]:
    return {p.stem: p for p in sorted(CSRC.glob("*.cu"))}


def build_dir() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.iterdir()):
        if p.suffix in (".cu", ".cuh"):
            h.update(p.name.encode())
            h.update(p.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def build_all() -> Dict[str, Path]:
    """Compile every kernel source (in parallel); return name -> library."""
    out_dir = build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    srcs = sources()
    libs = {name: out_dir / f"{name}.so" for name in srcs}
    todo = [n for n, lib in libs.items() if not lib.exists()]
    if not todo:
        return libs
    nvcc = _nvcc()
    procs = {}
    for name in todo:
        tmp = out_dir / f"{name}.{os.getpid()}.tmp.so"
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(srcs[name])]
        procs[name] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                             stderr=subprocess.STDOUT,
                                             text=True))
    failed = []
    for name, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"--- {name}.cu (nvcc exit {proc.returncode}) ---\n"
                          f"{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, libs[name])
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return libs


def library(name: str, signatures: Dict[str, Sequence]) -> ctypes.CDLL:
    """The loaded kernel library ``name`` (building all kernels on first use).

    ``signatures`` maps each C entry to its ``argtypes``; every entry returns
    a ``cudaError_t`` as int.  Pointers and the stream are ``c_void_p``.
    """
    with _LOCK:
        if name in _LIBS:
            return _LIBS[name]
        paths = build_all()
        if name not in paths:
            raise RuntimeError(f"no kernel source csrc/{name}.cu")
        lib = ctypes.CDLL(str(paths[name]))
        lib.repro_error_string.argtypes = [ctypes.c_int]
        lib.repro_error_string.restype = ctypes.c_char_p
        for fn, argtypes in signatures.items():
            getattr(lib, fn).argtypes = list(argtypes)
            getattr(lib, fn).restype = ctypes.c_int
        _LIBS[name] = lib
        return lib


def check_launch(lib: ctypes.CDLL, err: int, name: str) -> None:
    if err != 0:
        msg = lib.repro_error_string(err).decode()
        raise RuntimeError(f"{name}: kernel launch failed: CUDA error {err} "
                           f"({msg})")
