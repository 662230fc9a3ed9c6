"""Build the CUDA kernels from ``peritext_tpu_torch/csrc`` at first use.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for Hopper (``sm_90a``) into
its own shared library with a plain C interface, loaded with ``ctypes`` —
no PyTorch headers, so a build takes seconds.  Libraries land in
``peritext_tpu_torch/build/`` (git-ignored), named by a hash of the sources
and flags, so an edited kernel is rebuilt and a stale library is never
loaded.  ``build_all`` starts one ``nvcc`` per source at once.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, Optional

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "build"
KERNELS = ("text_phase", "mark_phase")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

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


def _library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC_DIR.glob("*.cu*")):
        if src.suffix == ".cuh" or src.stem == name:
            h.update(src.name.encode())
            h.update(src.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


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
            tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
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
