"""Build the CUDA sources under ``csrc/`` with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and compiles on its own into
``build/repro_torch/lib<name>-<digest>.so`` at the repository root, where
``<digest>`` hashes the source, the shared headers (``csrc/*.cuh``) and the
flags, so an edited source is never served from a stale library.  Nothing is built at import time: a library is
built at its first use, or all of them at once (one nvcc per source, all
started together) by :func:`build`.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

__all__ = ["SOURCES", "BUILD_DIR", "NVCC_FLAGS", "build", "load", "sass"]

SOURCES = ("coded_fused", "coded_decode", "coded_encode", "block_matmul",
           "wkv_scan", "mamba_scan")
_CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: dict = {}


def _nvcc() -> str:
    for home in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH")):
        if home and (Path(home) / "bin" / "nvcc").is_file():
            return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not Path(found).is_file():
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME); the CUDA kernels build only on "
            "a machine with the CUDA toolkit")
    return found


def _library_path(name: str) -> Path:
    src = (_CSRC / f"{name}.cu").read_bytes()
    src += b"".join(h.read_bytes() for h in sorted(_CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names=SOURCES) -> dict:
    """Build the named libraries that are not built yet, in parallel.

    Returns ``{name: compiler log}`` (nvcc's ``-Xptxas -v`` report of
    registers, shared memory and spills; empty for a library already
    built).

    Raises:
        RuntimeError: if nvcc is missing or a compilation fails.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    logs = {}
    running = []
    for name in names:
        path = _library_path(name)
        if path.is_file():
            logs[name] = ""
            continue
        tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(_CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        running.append((name, proc, tmp, path))
    failed = []
    for name, proc, tmp, path in running:
        out, _ = proc.communicate()
        logs[name] = out
        if proc.returncode != 0:
            failed.append(f"{name}.cu (exit {proc.returncode}):\n{out}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, path)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built at first use."""
    lib = _LIBS.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(_library_path(name)))
        _LIBS[name] = lib
    return lib


def sass(name: str) -> str:
    """``cuobjdump -sass`` of the library for ``csrc/<name>.cu``, built
    first if it is not: the machine code the card runs."""
    build([name])
    cuobjdump = Path(_nvcc()).parent / "cuobjdump"
    return subprocess.run([str(cuobjdump), "-sass", str(_library_path(name))],
                          capture_output=True, text=True, check=True).stdout
