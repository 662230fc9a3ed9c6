"""What every driver shares: finding a cell by name, the run's record, the
statistics of the end-to-end metrics, the reading of a profiler trace, and
the result line.  Imports nothing of the port."""
from __future__ import annotations

import importlib.util
import json
import math
import sys
import time
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

ROOT = Path(__file__).resolve().parent.parent
HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "peritext_tpu")
NAME_CHARS = 160  # of an op's name in the breakdown


def load_benchmark(root: Path = ROOT) -> Dict[str, Any]:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def load_cell(name: str, root: Path = ROOT) -> Dict[str, Any]:
    """The workload entry ``name`` with its configuration (from the file
    ``BENCHMARK.json`` names) and its traffic mix (``traffic/<name>.json``),
    and the metrics that the cell reports, by kind."""
    bench = load_benchmark(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; known: {', '.join(sorted(cells))}")
    cell = cells[name]
    config = next(c for c in bench["configs"] if c["name"] == cell["config"])
    with open(root / config["file"]) as f:
        cfg = json.load(f)
    with open(HERE / "traffic" / f"{cell['traffic']}.json") as f:
        traffic = json.load(f)

    def mine(metrics: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
        return [m for m in metrics if name in m.get("workloads", [name])]

    return {"name": name, "chips": cell["chips"], "config": cfg, "traffic": traffic,
            "end_to_end": mine(bench["end_to_end"]), "per_layer": mine(bench["per_layer"])}


def reader(metric: str) -> Callable[[Dict[str, Any]], Optional[float]]:
    """The ``read`` function of ``metrics/<metric>.py``."""
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{metric.replace('.', '_').replace('-', '_')}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def p95(values: Sequence[float]) -> float:
    """The 95th percentile by nearest rank: the smallest value with at least
    95% of the values at or below it (``inf`` counts as the largest)."""
    xs = sorted(values)
    return xs[max(0, math.ceil(0.95 * len(xs)) - 1)]


def forbidden_modules() -> List[str]:
    """Modules loaded in this process whose top-level name is one of
    ``FORBIDDEN``, compared whole."""
    return sorted(n for n in list(sys.modules) if n.split(".", 1)[0] in FORBIDDEN)


class Check:
    """One number compared with its limit: the run is correct while every
    value is at or below its limit."""

    def __init__(self, name: str, value: float, limit: float):
        self.name, self.value, self.limit = name, value, limit

    @property
    def ok(self) -> bool:
        return self.value <= self.limit


# -- the profiler's trace ---------------------------------------------------------------------------


def _is_device(evt) -> bool:
    return str(getattr(evt, "device_type", "")).endswith("CUDA")


def _union(dev: Sequence[tuple]) -> Tuple[float, List[Tuple[float, float]], Optional[float]]:
    """Busy microseconds of sorted device intervals ``(start, end, ...)``
    (their union), the gaps between them, and the end of the last."""
    busy_us = 0.0
    gaps: List[Tuple[float, float]] = []
    cur_s = cur_t = None
    for s, t, *_ in dev:
        if cur_t is None:
            cur_s, cur_t = s, t
        elif s > cur_t:
            busy_us += cur_t - cur_s
            gaps.append((cur_t, s))
            cur_s, cur_t = s, t
        else:
            cur_t = max(cur_t, t)
    if cur_t is not None:
        busy_us += cur_t - cur_s
    return busy_us, gaps, cur_t


def summarize_profile(prof, wall_s: float, t_begin_us: Optional[float] = None, cards: int = 1) -> Dict[str, Any]:
    """Per card of the cell (``device_index`` 0 to ``cards`` - 1): its busy
    seconds (the union of its kernel, copy and set intervals) and its idle
    gaps, labelled by the innermost host op or span that covers each gap's
    middle; while any card of the cell ran an op, one that ran none is idle
    the whole slice.  ``busy_s`` sums the cards' busy seconds
    (device-seconds), ``busy_any_s`` is the union over the cards,
    ``per_card`` each card's by index; the device time of each operation
    by name summed over the cards, the ten longest gaps over all cards,
    and ``wall_s``, the traced window's length.  Ops on a card outside the
    cell are left out of all of these: ``other_cards`` holds their busy
    seconds by card.

    Ranges mirrored on a device's timeline from host ranges (the harness's
    ``portbench.*`` spans, the port's telemetry spans) are not device work:
    the profiler marks them as user annotations, and they are left out.  A
    profiler whose events lack that mark fails here."""
    events = prof.events()
    host = [(e.time_range.start, e.time_range.end, e.name) for e in events if not _is_device(e)]
    by_name: Dict[str, float] = {}
    per: List[List[Tuple[float, float, str]]] = [[] for _ in range(cards)]
    other: Dict[int, List[Tuple[float, float]]] = {}
    for e in events:
        if not _is_device(e) or e.is_user_annotation:
            continue
        s, t, n, i = e.time_range.start, e.time_range.end, e.name, e.device_index
        if not 0 <= i < cards:
            other.setdefault(i, []).append((s, t))
            continue
        by_name[n] = by_name.get(n, 0.0) + (t - s) * 1e-6
        per[i].append((s, t, n))
    ran = any(per)
    if host:
        first = min(h[0] for h in host) if t_begin_us is None else t_begin_us
        last = max(h[1] for h in host)
    per_card: List[float] = []
    gaps: List[Tuple[float, float]] = []
    for card in per:
        card.sort()
        busy_us, card_gaps, end = _union(card)
        if ran and host:
            card_gaps = [(first, card[0][0])] + card_gaps + [(end, last)] if card else [(first, last)]
        per_card.append(busy_us * 1e-6)
        gaps += card_gaps
    gaps = sorted((g for g in gaps if g[1] > g[0]), key=lambda g: g[0] - g[1])[:10]
    host.sort(key=lambda h: h[0])

    def label(mid: float) -> str:
        inner = None
        for s, t, n in host:
            if s > mid:
                break
            if t >= mid and (inner is None or t - s < inner[1] - inner[0]):
                inner = (s, t, n)
        return inner[2] if inner else "host: no op or span recorded"

    idle = [[label((a + b) / 2), (b - a) * 1e-6] for a, b in gaps]
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return {"busy_s": sum(per_card), "busy_any_s": _union(sorted(x for card in per for x in card))[0] * 1e-6,
            "cards": cards, "per_card": per_card,
            "other_cards": {i: _union(sorted(x))[0] * 1e-6 for i, x in sorted(other.items())},
            "window_s": wall_s, "by_name": by_name,
            "breakdown": {"device_ops": [[n[:NAME_CHARS], s] for n, s in top],
                          "idle_gaps": [[n[:NAME_CHARS], s] for n, s in idle]}}


def device_seconds(profile: Dict[str, Any], *needles: str) -> float:
    """Device seconds of the operations whose name holds any of ``needles``."""
    return sum(s for n, s in profile["by_name"].items() if any(k in n for k in needles))


# -- the result ------------------------------------------------------------------------------------


def result_line(rec: Dict[str, Any], metrics: List[Dict[str, Any]], trace: bool) -> Dict[str, Any]:
    """The last line of standard output: the cell's metrics (those its
    readers find something to read for), the device, and the checks last."""
    out: Dict[str, Any] = {"correct": all(c.ok for c in rec["checks"]) and rec["failed"] == 0,
                           "attempted": rec["attempted"], "failed": rec["failed"], "metrics": {}}
    for m in metrics:
        value = reader(m["name"])(rec)
        if value is not None:
            out["metrics"][m["name"]] = {"value": value, "unit": m["unit"]}
    out["device"] = dict(rec["device"])
    if trace and rec.get("profile"):
        out["device"]["busy_s"] = rec["profile"]["busy_s"] / rec["profile"].get("cards", 1)  # a card's mean
        out["device"]["window_s"] = rec["profile"]["window_s"]
        out["breakdown"] = rec["profile"]["breakdown"]
    out["checks"] = {c.name: {"value": c.value, "limit": c.limit} for c in rec["checks"]}
    return out


def card_memory_peaks(cards: int) -> List[int]:
    """Each card's peak of allocated bytes (``torch.cuda.max_memory_allocated``),
    cards 0 to ``cards`` - 1; the largest is the fullest card's."""
    import torch

    return [int(torch.cuda.max_memory_allocated(i)) for i in range(cards)]


class Clock:
    """The run's host clock: ``t0`` is when the process began its set-up."""

    def __init__(self, t0: Optional[float] = None):
        self.t0 = time.perf_counter() if t0 is None else t0

    def since(self) -> float:
        return time.perf_counter() - self.t0


# -- helpers the metric readers share ------------------------------------------------------------


def idle_pct(rec: Dict[str, Any]) -> Optional[float]:
    """The traced slice's share of card-time in which no device op ran:
    1 - busy device-seconds / (cards x the slice)."""
    prof = rec.get("profile")
    if not prof or prof["busy_s"] <= 0 or prof["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - prof["busy_s"] / (prof.get("cards", 1) * prof["window_s"]))


def merge_roofline_pct(rec: Dict[str, Any]) -> Optional[float]:
    """The traced merges' least time at the HBM rate (the frozen byte count)
    over the device time of the two merge kernels in the trace."""
    from portbench.roofline import bound_seconds

    prof, layers = rec.get("profile"), rec.get("layers") or {}
    if not prof or not layers.get("merges"):
        return None
    kernel_s = device_seconds(prof, "text_phase", "mark_phase")
    if kernel_s <= 0:
        return None
    return 100.0 * bound_seconds(layers["merge_bytes"]) / kernel_s
