"""Run one cell of the benchmark and print its result line.

    python3 -m portbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The cell's traffic file names its driver
(``drivers/<driver>.py``), which sets up the port, measures for
``--seconds`` and checks what the timed path produced against the plain
reference.  With ``--trace 0`` the line carries the cell's end-to-end
metrics, with ``--trace 1`` its per-layer metrics, the device's busy
seconds and a breakdown of the traced slice.  The numbers compared for
``correct`` go last, on standard error and in the line.  Exits non-zero,
printing no result, without enough CUDA devices, or when JAX or the JAX
package was loaded.
"""
from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from typing import Any, Dict, Optional  # noqa: E402

from portbench import core  # noqa: E402

# Every build and kernel cache of the program lives at a fixed path in the
# checkout; the port's own nvcc outputs already do (peritext_tpu_torch/build).
CACHE = core.ROOT / ".portbench_cache"


def run_cell(cell: Dict[str, Any], seed: int, seconds: float, trace: bool, device: str,
             clock: Optional[core.Clock] = None, **driver_kw) -> Dict[str, Any]:
    """Drive ``cell`` and return its record and result line (no check for a
    card: the tests run cells on the CPU at small sizes)."""
    driver = importlib.import_module(f"portbench.drivers.{cell['traffic']['driver']}")
    rec = driver.run(cell, seed=seed, seconds=seconds, trace=trace, device=device, clock=clock or core.Clock(),
                     **driver_kw)
    metrics = cell["per_layer"] if trace else cell["end_to_end"]
    return {"rec": rec, "line": core.result_line(rec, metrics, trace)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = str(CACHE / sub)

    import torch

    cell = core.load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: {args.workload} needs {cell['chips']} CUDA device(s); this machine has {n}",
              file=sys.stderr)
        return 2
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda", core.Clock(T0))
    bad = core.forbidden_modules()
    if bad:
        print(f"portbench: modules of JAX or the JAX package were loaded: {', '.join(bad)}", file=sys.stderr)
        return 3
    line = out["line"]
    sys.stdout.flush()
    for name, c in line["checks"].items():
        print(f"check {name} = {c['value']} (limit {c['limit']})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line))
    sys.stdout.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
