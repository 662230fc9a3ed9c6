"""The trace summary, the idle share and the memory peak reckoned per card:
on one card exactly what they were before (a frozen copy of the summary
as it was), on four the cards' busy seconds, their sum and their union;
the ranges mirrored from the host left out of busy time."""
from __future__ import annotations

import contextlib
import random
import types
from typing import Any, Dict, List, Optional, Tuple

import pytest

from portbench import core
from portbench.drivers import _trace
from portbench.drivers.epochs import device_entry


# The summary of one card's trace as it was before cards were reckoned apart, kept to hold the new one to it.
def frozen_summarize_profile(prof, wall_s: float, t_begin_us: Optional[float] = None) -> Dict[str, Any]:
    """Busy seconds (the union of the device's kernel, copy and set
    intervals), the device time of each operation by name, the ten longest
    idle gaps labelled by the innermost host op or span that covers each
    gap's middle, and ``wall_s``, the traced window's length."""
    events = prof.events()
    dev: List[Tuple[float, float, str]] = []
    host: List[Tuple[float, float, str]] = []
    for e in events:
        tr = e.time_range
        if core._is_device(e):
            if not e.name.startswith("portbench."):  # the harness's spans, mirrored on the device's timeline
                dev.append((tr.start, tr.end, e.name))
        else:
            host.append((tr.start, tr.end, e.name))
    by_name: Dict[str, float] = {}
    for s, t, n in dev:
        by_name[n] = by_name.get(n, 0.0) + (t - s) * 1e-6
    dev.sort()
    busy_us = 0.0
    gaps: List[Tuple[float, float]] = []
    cur_s = cur_t = None
    for s, t, _ in dev:
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
    if dev and host:
        first = min(h[0] for h in host) if t_begin_us is None else t_begin_us
        last = max(h[1] for h in host)
        gaps = [(first, dev[0][0])] + gaps + [(cur_t, last)]
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
    return {"busy_s": busy_us * 1e-6, "window_s": wall_s, "by_name": by_name,
            "breakdown": {"device_ops": [[n[:core.NAME_CHARS], s] for n, s in top],
                          "idle_gaps": [[n[:core.NAME_CHARS], s] for n, s in idle]}}



def _evt(name, start, end, device="CUDA", card=0, mirrored=False):
    """A ``FunctionEvent`` as the summary reads it; ``mirrored`` is the
    profiler's mark of a user annotation (``is_user_annotation``)."""
    return types.SimpleNamespace(name=name, time_range=types.SimpleNamespace(start=start, end=end),
                                 device_type=f"DeviceType.{device}", device_index=card, is_user_annotation=mirrored)


def _prof(events):
    return types.SimpleNamespace(events=lambda: events)


KERNELS = ["void (anonymous namespace)::text_phase_kernel<128, false>(int)", "Memcpy HtoD (Pinned -> Device)",
           "void (anonymous namespace)::mark_phase_kernel<false>(int)", "Memset (Device)", "k" * 200]
HOST = ["portbench.apply_changes", "aten::copy_", "cudaLaunchKernel", "aten::empty", "cudaStreamSynchronize"]


def random_trace(seed: int) -> Tuple[list, float, Optional[float]]:
    """A one-card trace as the drivers see one: kernels, copies and sets
    that overlap and tie, the harness's spans on the host and mirrored on
    the device, float times; a window, and sometimes a start."""
    rng = random.Random(seed)
    events = []
    for _ in range(rng.randint(0, 12)):
        s = rng.uniform(0, 5000)
        events.append(_evt(rng.choice(HOST), s, s + rng.uniform(0, 3000), "CPU", card=-1))
    for _ in range(rng.randint(0, 60)):
        s = rng.choice([rng.uniform(0, 5000), float(rng.randint(0, 50) * 100)])
        events.append(_evt(rng.choice(KERNELS), s, s + rng.choice([rng.uniform(0, 300), 100.0])))
    for _ in range(rng.randint(0, 3)):
        s = rng.uniform(0, 5000)
        events.append(_evt("portbench.apply_changes", s, s + rng.uniform(0, 2000), mirrored=True))
    rng.shuffle(events)
    return events, rng.uniform(0.001, 0.01), rng.choice([None, rng.uniform(-100, 100)])


@pytest.mark.parametrize("seed", range(40))
def test_one_card_is_as_before(seed):
    events, wall, begin = random_trace(seed)
    was = frozen_summarize_profile(_prof(events), wall, begin)
    now = core.summarize_profile(_prof(events), wall, begin)
    for key, value in was.items():
        assert now[key] == value, key
    assert now["cards"] == 1 and now["per_card"] == [now["busy_s"]] and now["busy_any_s"] == now["busy_s"]
    assert now["other_cards"] == {}
    before = 100.0 * (1.0 - was["busy_s"] / was["window_s"]) if was["busy_s"] > 0 else None
    assert core.idle_pct({"profile": now}) == before
    if was["busy_s"] > 0:
        rec = {"checks": [], "attempted": 1, "failed": 0, "device": {}, "profile": now}
        line = core.result_line(rec, [], True)
        assert line["device"]["busy_s"] == was["busy_s"] and line["breakdown"] == was["breakdown"]


def four_cards():
    host = [_evt("portbench.step", 0, 2000, "CPU", card=-1), _evt("aten::copy_", 100, 300, "CPU", card=-1)]
    dev = [_evt("k1", 0, 100, card=0), _evt("k2", 50, 150, card=0), _evt("k1", 100, 300, card=1),
           _evt("k1", 1000, 1100, card=3)]
    return host + dev


def test_four_cards_are_reckoned_apart():
    s = core.summarize_profile(_prof(four_cards()), 0.002, cards=4)
    assert s["cards"] == 4 and s["other_cards"] == {}
    assert s["per_card"] == pytest.approx([150e-6, 200e-6, 0.0, 100e-6])  # by device_index: card 2 ran nothing
    assert s["busy_s"] == pytest.approx(450e-6)  # device-seconds: the cards' sum
    assert s["busy_any_s"] == pytest.approx(400e-6)  # [0, 300] and [1000, 1100] on any card
    assert s["by_name"] == pytest.approx({"k1": 400e-6, "k2": 100e-6})
    assert s["breakdown"]["device_ops"][0] == ["k1", pytest.approx(400e-6)]
    # Each card's gaps from the first host event to its last op, longest first over all cards; card 2 idle throughout.
    gaps = s["breakdown"]["idle_gaps"]
    assert [g[1] for g in gaps] == pytest.approx([2000e-6, 1850e-6, 1700e-6, 1000e-6, 900e-6, 100e-6])
    assert {g[0] for g in gaps} == {"portbench.step"}
    assert core.idle_pct({"profile": s}) == pytest.approx(100.0 * (1 - 450e-6 / (4 * 0.002)))
    line = core.result_line({"checks": [], "attempted": 1, "failed": 0, "device": {}, "profile": s}, [], True)
    assert line["device"]["busy_s"] == pytest.approx(450e-6 / 4)  # averaged over the cards used


def test_a_card_outside_the_cell_is_kept_apart():
    s = core.summarize_profile(_prof(four_cards()), 0.002, cards=1)
    assert s["cards"] == 1 and s["per_card"] == pytest.approx([150e-6]) and s["busy_s"] == pytest.approx(150e-6)
    assert s["other_cards"] == pytest.approx({1: 200e-6, 3: 100e-6})
    assert s["by_name"] == pytest.approx({"k1": 100e-6, "k2": 100e-6})
    assert core.idle_pct({"profile": s}) == pytest.approx(100.0 * (1 - 150e-6 / 0.002))


def test_mirrored_ranges_are_not_busy():
    events = [_evt("ingest.group", 0, 500, "CPU", card=-1, mirrored=True),
              _evt("stream.wait", 600, 900, "CPU", card=-1, mirrored=True),
              _evt("ingest.group", 100, 400, mirrored=True), _evt("stream.wait", 650, 850, mirrored=True),
              _evt("k1", 100, 200), _evt("k1", 700, 750)]
    s = core.summarize_profile(_prof(events), 0.001)
    assert s["busy_s"] == pytest.approx(150e-6) and s["by_name"] == pytest.approx({"k1": 150e-6})
    assert core.idle_pct({"profile": s}) == pytest.approx(85.0)
    # As the summary was before, the mirrored ranges fill the gaps between the kernels.
    assert frozen_summarize_profile(_prof(events), 0.001)["busy_s"] == pytest.approx(500e-6)


def test_a_device_event_without_the_mark_fails():
    bare = types.SimpleNamespace(name="k1", time_range=types.SimpleNamespace(start=0, end=100),
                                 device_type="DeviceType.CUDA", device_index=0)
    with pytest.raises(AttributeError):
        core.summarize_profile(_prof([bare]), 0.001)


def test_fullest_card_peak(monkeypatch):
    import torch

    peaks = {0: 5_000, 1: 9_000, 2: 7_000, 3: 1_000}
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda device=None: peaks[0 if device is None else device])
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda device=None: "a card")
    assert core.card_memory_peaks(4) == [5_000, 9_000, 7_000, 1_000]
    entry = device_entry("cuda", 4, core.card_memory_peaks(4))
    assert entry["memory_peak_bytes"] == 9_000 and entry["memory_peak_bytes_per_card"] == [5_000, 9_000, 7_000, 1_000]
    one = device_entry("cuda", 1, core.card_memory_peaks(1))
    assert one["memory_peak_bytes"] == torch.cuda.max_memory_allocated() and one["count"] == 1
    assert device_entry("cpu", 1, [0])["memory_peak_bytes"] == 0


@pytest.mark.parametrize("cards", [1, 4])
def test_slice_synchronizes_every_card(monkeypatch, cards):
    import torch

    synced: List[Any] = []
    monkeypatch.setattr(torch.cuda, "synchronize", lambda device=None: synced.append(device))
    monkeypatch.setattr(torch.profiler, "profile", lambda **kw: contextlib.nullcontext(_prof(four_cards())))
    with _trace.Slice(True, "cuda", cards=cards) as sl:
        assert synced == list(range(cards))
    assert synced == list(range(cards)) * 2
    assert sl.profile["cards"] == cards
