"""Time the merge kernels of two checkouts of this repository on one card,
in turns, on the same inputs.

    python3 -m peritext_tpu_torch.bench.kernel_ab OTHER_CHECKOUT [--rounds N]

Each turn is a fresh Python process whose ``peritext_tpu_torch`` is one
checkout's, so each side builds and runs its own ``csrc``.  The order is
other, this, this, other (``--rounds`` times), so drift on the card shows
as a difference between the two turns of one side.  Inputs are the
benchmark batch of ``chip_smoke.py`` phase 2 (1024 replicas, a 1000-char
document, 4 writer streams of 64 ops; C = 2048, M = 1024), built by each
side's own, unchanged ``build_device_batch`` from the same seeds, plus an
insert-heavy text batch written once by this checkout.  Per turn it prints
one JSON line: each kernel's ``call_ms`` (events around one wrapper call,
``chip_smoke.py``'s ``ms``) and ``device_ms`` (the kernel alone, cold L2),
``merge_step_full``'s ``call_ms``, and ``convergence_digest``'s ``call_ms``
with a hash of its digests (equal on both sides when the two digests
agree) on the merged states and on 1024 random short documents (C = 256)
under a full mark table (M = 1024), written once by this checkout.  Both
sides are timed by this checkout's ``timing.py``, so they share one
yardstick.  The workers call ``text_phase``, ``mark_phase``,
``merge_step_full``, ``convergence_digest``, ``state_from_numpy``,
``allow_multiple_array`` and ``build_device_batch`` as the port has had
them since its first slices: a checkout with other signatures needs this
script changed.  Needs one CUDA device.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve()
REPO = HERE.parents[2]
INPUTS = REPO / "peritext_tpu_torch" / "build" / "kernel_ab_inputs.pt"
FULL_TABLE = REPO / "peritext_tpu_torch" / "build" / "kernel_ab_full_table.npz"


def _timing():
    """This checkout's timing module, loaded by path: the worker's
    ``peritext_tpu_torch`` is the other side's when it times that side."""
    spec = importlib.util.spec_from_file_location("_kernel_ab_timing", HERE.parent / "timing.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _batch(device):
    from peritext_tpu_torch.bench.workloads import build_device_batch, make_merge_workload

    wl = make_merge_workload(1000, 64, 4, True, seed=0)
    return build_device_batch(wl, 1024, 2048, 1024, device=device)


def _full_table_state(rng, replicas=1024, capacity=256, marks=1024, actors=4) -> dict:
    """Random state fields of short documents under a full mark table
    (every column live, random masks): the digest's largest mark expansion
    for its element count."""
    import numpy as np

    from peritext_tpu_torch.schema import NUM_MARK_TYPES

    r, c, m = replicas, capacity, marks
    i32 = np.int32
    return {
        "elem_ctr": rng.integers(1, 1 << 20, (r, c), dtype=i32),
        "elem_act": rng.integers(0, actors, (r, c), dtype=i32),
        "deleted": rng.random((r, c)) < 0.1,
        "chars": rng.integers(32, 127, (r, c), dtype=i32),
        "bnd_def": rng.random((r, 2 * c)) < 0.5,
        "bnd_mask": rng.integers(0, 1 << 32, (r, 2 * c, m // 32), dtype=np.uint32),
        "mark_ctr": (np.argsort(rng.random((r, m)), axis=1) + 1).astype(i32),
        "mark_act": rng.integers(0, actors, (r, m), dtype=i32),
        "mark_action": rng.integers(0, 2, (r, m), dtype=i32),
        "mark_type": rng.integers(0, NUM_MARK_TYPES, (r, m), dtype=i32),
        "mark_attr": rng.integers(-1, 16, (r, m), dtype=i32),
        "length": np.full(r, c, i32),
        "mark_count": np.full(r, m, i32),
    }


def _digest_entry(K, states, ranks, multi, timing) -> dict:
    import hashlib

    digest = K.convergence_digest(states, ranks, multi)
    return {
        "call_ms": timing.call_ms(lambda: K.convergence_digest(states, ranks, multi), 20),
        "mark_count_max": int(states.mark_count.max().item()),
        "sha256": hashlib.sha256(digest.cpu().numpy().astype("uint32").tobytes()).hexdigest()[:16],
    }


def worker(label: str) -> None:
    import numpy as np
    import torch
    from peritext_tpu_torch.ops import cuda_kernels
    from peritext_tpu_torch.ops import kernels as K
    from peritext_tpu_torch.ops.state import state_from_numpy
    from peritext_tpu_torch.schema import allow_multiple_array

    timing = _timing()
    b = _batch("cuda")
    st = b["states"]
    heavy = torch.load(INPUTS)
    out = {"side": label, "package": str(Path(cuda_kernels.__file__).resolve().parents[2])}
    texts = {
        "text_phase": (st.elem_ctr, st.elem_act, st.deleted, st.chars, st.length,
                       b["text_ops"], b["ranks"], b["char_buf"]),
        "text_phase_insert_heavy": (st.elem_ctr, st.elem_act, st.deleted, st.chars, st.length,
                                    heavy["text_ops"].cuda(), b["ranks"], heavy["char_buf"].cuda()),
    }
    for name, args in texts.items():
        want = K.text_phase_plain(*args)
        got = cuda_kernels.text_phase(*args)
        torch.cuda.synchronize()
        if not all(torch.equal(g, w) for g, w in zip(got, want)):
            raise AssertionError(f"{label}: {name} differs from its plain version")
        out[name] = {
            "call_ms": timing.call_ms(lambda a=args: cuda_kernels.text_phase(*a), 20),
            "device_ms": timing.device_ms(lambda a=args: cuda_kernels.text_phase(*a), 20),
        }
    ec, ea, _, _, oi, ln = K.text_phase_plain(*texts["text_phase"])
    bnd_def, bnd_mask = K._permute_boundaries(st.bnd_def, st.bnd_mask, oi)
    mark_in = (bnd_def, bnd_mask, ec, ea, ln, st.mark_count, b["mark_ops"])
    out["mark_phase"] = {
        "call_ms": timing.call_ms(lambda: cuda_kernels.mark_phase(*mark_in), 20),
        "device_ms": timing.device_ms(lambda: cuda_kernels.mark_phase(*mark_in), 20),
    }
    merge_in = (st, b["text_ops"], b["mark_ops"], b["ranks"], b["char_buf"])
    out["merge_step_full"] = {
        "call_ms": timing.call_ms(lambda: cuda_kernels.merge_step_full(*merge_in), 20),
    }
    multi = torch.from_numpy(allow_multiple_array()).to("cuda")
    merged = cuda_kernels.merge_step_full(*merge_in)
    out["convergence_digest"] = _digest_entry(K, merged, b["ranks"], multi, timing)
    full = state_from_numpy(dict(np.load(FULL_TABLE)), device="cuda")
    ranks = torch.arange(4, dtype=torch.int32, device="cuda")
    out["convergence_digest_full_table"] = _digest_entry(K, full, ranks, multi, timing)
    print(json.dumps(out), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("other", help="root of the other checkout")
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        worker(args.worker)
        return 0

    import numpy as np
    import torch

    from peritext_tpu_torch.bench.workloads import insert_heavy_text_ops

    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 2
    INPUTS.parent.mkdir(parents=True, exist_ok=True)
    ops, buf = insert_heavy_text_ops(np.random.default_rng(0), _batch("cpu")["states"], 64, 128)
    torch.save({"text_ops": ops, "char_buf": buf}, INPUTS)
    np.savez(FULL_TABLE, **_full_table_state(np.random.default_rng(1)))
    sides = {"other": Path(args.other).resolve(), "this": REPO}
    for _ in range(args.rounds):
        for label in ("other", "this", "this", "other"):
            root = sides[label]
            env = dict(os.environ, PYTHONPATH=str(root))
            subprocess.run([sys.executable, str(HERE), args.other, "--worker", label],
                           cwd=root, env=env, check=True, timeout=900)
    return 0


if __name__ == "__main__":
    sys.exit(main())
