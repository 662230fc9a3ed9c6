"""Build the CUDA kernels from ``peritext_tpu_torch/csrc`` at first use.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for Hopper (``sm_90a``) into
its own shared library with a plain C interface, loaded with ``ctypes`` —
no PyTorch headers, so a build takes seconds.  Libraries land in
``peritext_tpu_torch/build/`` (git-ignored), named by a hash of the sources
and flags, so an edited kernel is rebuilt and a stale library is never
loaded.  ``build_all`` starts one ``nvcc`` per source at once.
``build_host_library`` builds a ``csrc/<name>.cpp`` host library (the
change-log codec) with ``g++`` the same way.
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

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "build"
KERNELS = ("text_phase", "mark_phase", "digest")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
# Host C++ libraries (``csrc/*.cpp``): the flags of ``native/Makefile``.
CXX_FLAGS = ("-O3", "-Wall", "-Wextra", "-fPIC", "-std=c++17", "-shared")

# What nvcc printed for each library built in this process (register and
# shared-memory use, from -Xptxas -v).
build_logs: Dict[str, str] = {}
_loaded: Dict[str, ctypes.CDLL] = {}


class KernelBuildError(RuntimeError):
    """A kernel could not be built: no ``nvcc``, or ``nvcc`` failed.  Not a
    transient fault, so the launch policy does not retry it."""


def nvcc_path() -> str:
    """The CUDA compiler: ``$NVCC``, else ``nvcc`` on PATH, else under the
    toolkit PyTorch found (``CUDA_HOME``).  Raises when there is none."""
    explicit = os.environ.get("NVCC")
    if explicit:
        return explicit
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise KernelBuildError(
        "nvcc not found (set NVCC, put nvcc on PATH or set CUDA_HOME): "
        "the CUDA kernels cannot be built"
    )


def _hashed_path(name: str, flags: Iterable[str], sources: Iterable[Path]) -> Path:
    h = hashlib.sha256(" ".join(flags).encode())
    for src in sources:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def _library_path(name: str) -> Path:
    sources = [
        src for src in sorted(CSRC_DIR.glob("*.cu*"))
        if src.suffix == ".cuh" or src.name == f"{name}.cu"
    ]
    return _hashed_path(name, NVCC_FLAGS, sources)


def _tmp_path(out: Path) -> Path:
    """A name no other process or thread builds ``out`` under, so that
    concurrent first builds each finish with one ``os.replace``."""
    return out.with_name(f"{out.stem}.{os.getpid()}.{threading.get_ident()}.tmp.so")


def build_host_library(name: str) -> Path:
    """Compile ``csrc/<name>.cpp`` (plain C++ with a C interface, no CUDA)
    with ``$CXX`` (default ``g++``) and :data:`CXX_FLAGS` unless a current
    library exists.  Raises ``OSError`` when there is no compiler and
    ``subprocess.CalledProcessError`` when the build fails."""
    src = CSRC_DIR / f"{name}.cpp"
    out = _hashed_path(name, CXX_FLAGS, [src])
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = _tmp_path(out)
    cmd = [os.environ.get("CXX") or "g++", *CXX_FLAGS, "-o", str(tmp), str(src)]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, out)
    finally:
        tmp.unlink(missing_ok=True)
    return out


def build_all(names: Iterable[str] = KERNELS) -> Dict[str, Path]:
    """Compile every named kernel that has no current library, one nvcc
    process per source, all started together.  Raises with nvcc's output
    when a build fails."""
    names = list(names)
    for name in names:
        if name not in KERNELS:
            raise ValueError(f"unknown kernel {name!r}; known: {KERNELS}")
    paths = {name: _library_path(name) for name in names}
    todo = {n: p for n, p in paths.items() if not p.exists()}
    if not todo:
        return paths
    nvcc = nvcc_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    failed = []
    try:
        for name, out in todo.items():
            tmp = _tmp_path(out)
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
            procs[name] = (
                subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
                tmp,
            )
        for name, (proc, tmp) in procs.items():
            log, _ = proc.communicate()
            build_logs[name] = log
            if proc.returncode != 0:
                failed.append(f"{name} (exit {proc.returncode}):\n{log}")
            else:
                os.replace(tmp, todo[name])
    finally:
        for proc, _ in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    if failed:
        raise KernelBuildError("nvcc failed for " + "\n".join(failed))
    return paths


def load(name: str) -> ctypes.CDLL:
    """The loaded library of one kernel, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build_all([name])[name]))
        _loaded[name] = lib
    return lib


def error_string(lib: ctypes.CDLL, err: int) -> str:
    fn = lib.pt_error_string
    fn.argtypes = [ctypes.c_int]
    fn.restype = ctypes.c_char_p
    msg: Optional[bytes] = fn(err)
    return msg.decode() if msg else f"CUDA error {err}"
