"""ctypes binding for the port's native change-log codec
(``peritext_tpu_torch/csrc/native_codec.cpp``).

Columnar zigzag+delta+LEB128 varint coding of int32 matrices — the encoded
form of op rows in :meth:`ChangeLog.to_bytes` for log shipping and durable
storage.  The library is built with ``g++`` at first use into
``peritext_tpu_torch/build/`` (``ops/_build.build_host_library``), named by
a hash of its source and flags; where no compiler exists a plain-Python
coder writes the identical format.  The bytes equal the JAX package's
codec's, so either package reads the other's logs.
"""
from __future__ import annotations

import ctypes
import subprocess
import threading
from typing import Optional

import numpy as np

_lib: Optional[ctypes.CDLL] = None
_lib_tried = False
_lock = threading.Lock()


def _load_library() -> Optional[ctypes.CDLL]:
    global _lib, _lib_tried
    with _lock:
        if _lib_tried:
            return _lib
        _lib_tried = True
        from peritext_tpu_torch.ops import _build

        try:
            lib = ctypes.CDLL(str(_build.build_host_library("native_codec")))
        except (OSError, subprocess.SubprocessError):
            return None
        lib.pt_encode_bound.restype = ctypes.c_size_t
        lib.pt_encode_bound.argtypes = [ctypes.c_size_t]
        lib.pt_encode_columns.restype = ctypes.c_size_t
        lib.pt_encode_columns.argtypes = [
            ctypes.POINTER(ctypes.c_int32),
            ctypes.c_size_t,
            ctypes.c_size_t,
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.c_size_t,
        ]
        lib.pt_decode_columns.restype = ctypes.c_size_t
        lib.pt_decode_columns.argtypes = [
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.c_size_t,
            ctypes.c_size_t,
            ctypes.c_size_t,
            ctypes.POINTER(ctypes.c_int32),
            ctypes.c_size_t,
        ]
        _lib = lib
        return _lib


def native_available() -> bool:
    return _load_library() is not None


def library_path() -> Optional[str]:
    """The loaded library's file, or None when the Python coder serves."""
    lib = _load_library()
    return None if lib is None else lib._name


# -- the plain-Python coder (same format) ------------------------------------


def _py_encode(columns: np.ndarray) -> bytes:
    out = bytearray()
    for col in columns:
        deltas = np.diff(col.astype(np.int64), prepend=np.int64(0)).astype(np.int32).astype(np.int64)
        for z in (((deltas << 1) ^ (deltas >> 31)) & 0xFFFFFFFF).tolist():
            while z >= 0x80:
                out.append((z & 0x7F) | 0x80)
                z >>= 7
            out.append(z)
    return bytes(out)


def _py_decode(data: bytes, n_cols: int, n_rows: int) -> np.ndarray:
    out = np.empty((n_cols, n_rows), np.int32)
    pos = 0
    for c in range(n_cols):
        prev = 0
        for r in range(n_rows):
            result = 0
            shift = 0
            while True:
                if pos >= len(data) or shift >= 35:
                    raise ValueError("malformed varint stream")
                b = data[pos]
                pos += 1
                # Mask to 32 bits so non-canonical 5-byte varints decode
                # as the native coder does (it ORs into a uint32).
                result = (result | ((b & 0x7F) << shift)) & 0xFFFFFFFF
                if not b & 0x80:
                    break
                shift += 7
            prev = (prev + ((result >> 1) ^ -(result & 1))) & 0xFFFFFFFF
            if prev >= 0x80000000:
                prev -= 0x100000000
            out[c, r] = prev
    if pos != len(data):
        raise ValueError("trailing bytes in varint stream")
    return out


# -- public API --------------------------------------------------------------


def encode_columns(matrix: np.ndarray, force_python: bool = False) -> bytes:
    """Encode an int32 [n_cols, n_rows] matrix (column-major semantics)."""
    matrix = np.ascontiguousarray(matrix, np.int32)
    if matrix.ndim != 2:
        raise ValueError("expected a 2-D matrix")
    lib = None if force_python else _load_library()
    if lib is None:
        return _py_encode(matrix)
    n_cols, n_rows = matrix.shape
    bound = lib.pt_encode_bound(matrix.size)
    out = np.empty(max(bound, 1), np.uint8)
    written = lib.pt_encode_columns(
        matrix.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        n_cols,
        n_rows,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        out.size,
    )
    if written == 0 and matrix.size > 0:
        raise RuntimeError("native encode failed")
    return out[:written].tobytes()


def decode_columns(
    data: bytes, n_cols: int, n_rows: int, force_python: bool = False
) -> np.ndarray:
    """Decode to an int32 [n_cols, n_rows] matrix."""
    if n_cols * n_rows == 0:
        if data:
            raise ValueError("trailing bytes in varint stream")
        return np.empty((n_cols, n_rows), np.int32)
    lib = None if force_python else _load_library()
    if lib is None:
        return _py_decode(data, n_cols, n_rows)
    buf = np.frombuffer(data, np.uint8)
    out = np.empty((n_cols, n_rows), np.int32)
    got = lib.pt_decode_columns(
        buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        buf.size,
        n_cols,
        n_rows,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        out.size,
    )
    if got != n_cols * n_rows:
        raise ValueError("malformed varint stream")
    return out
