"""Build the port's CUDA sources into shared libraries and load them.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into
``_build/lib<name>-<hash>.so`` (the hash is of the source and the flags, so
an edited source rebuilds) and loaded with ``ctypes``. The sources expose a
plain C interface, so a build takes seconds and needs no PyTorch headers.
Nothing is built when a module is imported: the first launch of a kernel
builds it, and ``build_all`` builds every source at once, one ``nvcc`` per
source, all started together. ``ptxas -v`` reports each kernel's registers,
shared memory and spills; ``build_logs`` keeps that output of the builds
this process ran.
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

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

build_logs: Dict[str, str] = {}
_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def find_nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME", ""), "/usr/local/cuda"):
        path = Path(cand) / "bin" / "nvcc"
        if cand and path.is_file():
            return str(path)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin "
            "and PATH): the port's CUDA kernels are built on the machine "
            "with the GPU")
    return found


def _target(name: str) -> Path:
    src = CSRC_DIR / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def _start(name: str, nvcc: str):
    """Start nvcc for one source unless its library exists; returns
    (target, process or None, temp path)."""
    target = _target(name)
    if target.exists():
        return target, None, None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return target, proc, tmp


def _finish(name: str, target: Path, proc, tmp: Path) -> None:
    if proc is None:
        return
    out, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu "
                           f"(exit {proc.returncode}):\n{out}")
    build_logs[name] = out
    os.replace(tmp, target)  # atomic: a concurrent build sees all or nothing


def build_all(names: Sequence[str]) -> Dict[str, Path]:
    """Compile every named source in parallel; returns name -> library."""
    nvcc = find_nvcc()
    started = {n: _start(n, nvcc) for n in names}
    try:
        for n, (target, proc, tmp) in started.items():
            _finish(n, target, proc, tmp)
    finally:
        for target, proc, tmp in started.values():
            if proc is not None and proc.poll() is None:
                proc.kill()
                proc.wait()
    return {n: started[n][0] for n in names}


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built at first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path = build_all([name])[name]
            lib = _libs[name] = ctypes.CDLL(str(path))
        return lib
