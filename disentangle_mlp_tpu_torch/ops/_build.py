"""Build the port's native sources into shared libraries and load them.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a``, and each
host-only ``csrc/<name>.cpp`` by ``g++``, into
``_build/lib<name>-<hash>.so`` (the hash is of the source and every flag,
its link flags included, so an edited source rebuilds) and loaded with
``ctypes``. The sources expose a plain C interface, so a build takes
seconds and needs no PyTorch headers. A source that links a library names
it in ``LINK_FLAGS`` (the nvJPEG binding ``-lnvjpeg``, the host JPEG
decoder ``-ljpeg``). Nothing is built when a module is imported: the first
call of a source's function builds it, and ``build_all`` builds every
named source at once, one compiler per source, all started together.
``ptxas -v`` reports each kernel's registers, shared memory and spills;
``build_logs`` keeps the compilers' output of the builds this process ran.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Sequence, Tuple

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")
GXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")
# libraries each source links, part of its build hash
LINK_FLAGS = {"nvjpeg_decode": ("-lnvjpeg",), "jpeg_host": ("-ljpeg",)}

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


def _source(name: str) -> Path:
    cu = CSRC_DIR / f"{name}.cu"
    return cu if cu.is_file() else CSRC_DIR / f"{name}.cpp"


def _flags(name: str) -> Tuple[Tuple[str, ...], Tuple[str, ...]]:
    """(compile flags, link flags) of one source."""
    compile_flags = NVCC_FLAGS if _source(name).suffix == ".cu" else GXX_FLAGS
    return compile_flags, LINK_FLAGS.get(name, ())


def _target(name: str) -> Path:
    flags = " ".join(sum(_flags(name), ()))
    digest = hashlib.sha256(_source(name).read_bytes()
                            + flags.encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def _start(name: str):
    """Start the compiler for one source unless its library exists; returns
    (target, process or None, temp path)."""
    target = _target(name)
    if target.exists():
        return target, None, None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    src = _source(name)
    compiler = find_nvcc() if src.suffix == ".cu" else "g++"
    compile_flags, link_flags = _flags(name)
    # libraries follow the source on the command line
    cmd = [compiler, *compile_flags, "-o", str(tmp), str(src), *link_flags]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return target, proc, tmp


def _finish(name: str, target: Path, proc, tmp: Path) -> None:
    if proc is None:
        return
    out, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"{proc.args[0]} failed for csrc/"
                           f"{_source(name).name} (exit {proc.returncode}):"
                           f"\n{out}")
    build_logs[name] = out
    os.replace(tmp, target)  # atomic: a concurrent build sees all or nothing


def build_all(names: Sequence[str]) -> Dict[str, Path]:
    """Compile every named source in parallel; returns name -> library."""
    started = {}
    try:
        for n in names:
            started[n] = _start(n)
    except BaseException:
        _stop(started)
        raise
    try:
        for n, (target, proc, tmp) in started.items():
            _finish(n, target, proc, tmp)
    finally:
        _stop(started)
    return {n: started[n][0] for n in names}


def _stop(started) -> None:
    for target, proc, tmp in started.values():
        if proc is not None and proc.poll() is None:
            proc.kill()
            proc.wait()


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu`` (or ``.cpp``), built at
    first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path = build_all([name])[name]
            lib = _libs[name] = ctypes.CDLL(str(path))
        return lib
