"""Time the text-phase kernel at every block size (128, 256, 512 and 1024
threads) on one CUDA device, at each capacity a ``TorchUniverse`` buckets
to up to C = 16384.

    python3 -m peritext_tpu_torch.bench.text_block_sweep [--replicas R] [--runs N]

The production library launches one block size per capacity
(``threads_for`` in ``csrc/text_phase.cu``); this script builds
``text_block_sweep.cu``, which includes that source and launches any of
the four.  Per capacity two inputs on the same states: the merge batch of
a document that fills the capacity (``make_merge_workload(doc, 64,
writers, True)`` through ``build_device_batch``: nearly all delete rows)
and insert-heavy rows (``insert_heavy_text_ops``: a quarter each of pads,
inserts, deletes and runs).  Every block size must be byte-equal to the
plain version.  Prints, per input, the row mix and per block size the
device ms (``timing.device_ms``: cold L2, median of N) and the blocks
resident per SM; then one JSON line per input.  Needs one CUDA device.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from peritext_tpu_torch.bench.timing import device_ms
from peritext_tpu_torch.bench.workloads import (
    build_device_batch,
    insert_heavy_text_ops,
    make_merge_workload,
    text_row_mix,
)
from peritext_tpu_torch.ops import _build, cuda_kernels
from peritext_tpu_torch.ops import kernels as K

THREADS = (128, 256, 512, 1024)
# (capacity, document length, writer streams): the benchmark document at
# C = 2048, the 10k-char latency document at 16384, and between them
# documents that fill about three quarters of their capacity.
SHAPES = ((2048, 1000, 4), (4096, 3000, 2), (8192, 6000, 2), (16384, 10_000, 2))

_P, _I = ctypes.c_void_p, ctypes.c_int


def build() -> ctypes.CDLL:
    """Compile ``text_block_sweep.cu`` into the build directory and load it."""
    src = Path(__file__).with_suffix(".cu")
    out = _build.BUILD_DIR / "text_block_sweep.so"
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC_DIR),
           "-o", str(out), str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {src.name}:\n{proc.stdout}{proc.stderr}")
    lib = ctypes.CDLL(str(out))
    lib.pt_sweep_text_phase.argtypes = [_P] * 6 + [_I, _P, _I, _P, _I] + [_P] * 6 + [_I, _I, _I, _P]
    lib.pt_sweep_text_phase.restype = _I
    lib.pt_sweep_blocks_per_sm.argtypes = [_I, _I]
    lib.pt_sweep_blocks_per_sm.restype = _I
    lib.pt_sweep_threads_for.argtypes = [_I]
    lib.pt_sweep_threads_for.restype = _I
    return lib


def text_phase(lib: ctypes.CDLL, threads: int, ec, ea, dl, ch, ln, ops, ranks, buf):
    """The text phase at ``threads`` per block, on inputs that
    ``cuda_kernels.text_phase`` accepts."""
    r, c = ec.shape
    out = [torch.empty_like(x) for x in (ec, ea, dl, ch, ec, ln)]
    err = lib.pt_sweep_text_phase(
        ec.data_ptr(), ea.data_ptr(), dl.data_ptr(), ch.data_ptr(), ln.data_ptr(),
        ops.data_ptr(), ops.shape[1], ranks.data_ptr(), ranks.shape[0],
        buf.data_ptr() if buf is not None else None, buf.shape[1] if buf is not None else 0,
        *(t.data_ptr() for t in out), r, c, threads, torch.cuda.current_stream().cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"text_phase at {threads} threads failed: {_build.error_string(lib, err)}")
    return tuple(out)


def sweep_input(lib: ctypes.CDLL, label: str, text_in, runs: int) -> dict:
    capacity = text_in[0].shape[1]
    print(f"[{label}] R={text_in[0].shape[0]} C={capacity} rows: {text_row_mix(text_in[5], text_in[7])}",
          flush=True)
    want = K.text_phase_plain(*text_in)
    row = {"input": label, "capacity": capacity, "production_threads": lib.pt_sweep_threads_for(capacity)}
    for threads in THREADS:
        got = text_phase(lib, threads, *text_in)
        torch.cuda.synchronize()
        if not all(torch.equal(g, w) for g, w in zip(got, want)):
            raise AssertionError(f"[{label}] {threads} threads differ from the plain version")
        ms = device_ms(lambda th=threads: text_phase(lib, th, *text_in), runs)
        blocks = lib.pt_sweep_blocks_per_sm(capacity, threads)
        row[str(threads)] = {"device_ms": ms, "blocks_per_sm": blocks}
        print(f"  {threads:4d} threads: {ms:.4f} ms device, {blocks} blocks per SM", flush=True)
    row["production_device_ms"] = device_ms(lambda: cuda_kernels.text_phase(*text_in), runs)
    print(f"  production ({row['production_threads']} threads): "
          f"{row['production_device_ms']:.4f} ms device", flush=True)
    return row


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--replicas", type=int, default=1024)
    ap.add_argument("--runs", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("text_block_sweep: no CUDA device", file=sys.stderr)
        return 2
    lib = build()
    rows = []
    for capacity, doc_len, writers in SHAPES:
        wl = make_merge_workload(doc_len, 64, writers, True, seed=0)
        b = build_device_batch(wl, args.replicas, capacity, 128, device="cuda")
        st = b["states"]
        planes = (st.elem_ctr, st.elem_act, st.deleted, st.chars, st.length)
        rows.append(sweep_input(lib, f"C={capacity} merge batch", (*planes, b["text_ops"], b["ranks"],
                                                                    b["char_buf"]), args.runs))
        ops, buf = insert_heavy_text_ops(np.random.default_rng(0), st, 64, 128)
        rows.append(sweep_input(lib, f"C={capacity} insert-heavy", (*planes, ops.cuda(), b["ranks"],
                                                                     buf.cuda()), args.runs))
        del b, st, planes
        torch.cuda.empty_cache()
    for row in rows:
        print(json.dumps(row))
    return 0


if __name__ == "__main__":
    sys.exit(main())
