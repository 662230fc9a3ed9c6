"""The metric arithmetic: rates over the whole window, the tail from due
times, roofline and idle shares, and the reading of a profiler trace."""
from __future__ import annotations

import math
import types

import pytest

from portbench import core
from portbench.roofline import HBM_BYTES_PER_S


def test_rates_over_the_whole_window():
    rec = {"delivered_ops": 3_000_000, "swept_replicas": 300_000, "window_s": 20.0, "setup_s": 12.5,
           "device_busy_s": 1.5, "layers": {"plain_ops": 2_400_000, "plain_s": 16.0}}
    assert core.reader("merged_ops_per_device_s")(rec) == 2_000_000.0
    assert core.reader("merged_ops_per_s.merge")(rec) == 150_000.0
    assert core.reader("swept_replicas_per_s")(rec) == 15_000.0
    assert core.reader("setup_s")(rec) == 12.5
    assert core.reader("merged_ops_per_device_s")({"delivered_ops": 1, "device_busy_s": None}) is None
    assert core.reader("merged_ops_per_s.merge")({"layers": {}}) is None


def test_p95_by_nearest_rank_counts_failures():
    lat = [i / 1000 for i in range(1, 101)]  # 1..100 ms
    assert core.p95(lat) == 0.095
    read = core.reader("admit_to_applied_p95_ms")
    assert read({"latencies_s": lat}) == pytest.approx(95.0)
    # Five failures push the 95th percentile to the largest served value ...
    assert read({"latencies_s": lat[:95] + [math.inf] * 5}) == pytest.approx(95.0)
    # ... and six make it a failure: no number.
    assert read({"latencies_s": lat[:94] + [math.inf] * 6}) is None


def test_roofline_share():
    prof = {"by_name": {"void (anonymous namespace)::text_phase_kernel<128, false>(int)": 0.001,
                        "void (anonymous namespace)::mark_phase_kernel<false>(int)": 0.003,
                        "elementwise_kernel": 5.0}, "busy_s": 1.0, "window_s": 4.0}
    rec = {"profile": prof, "layers": {"merges": 2, "merge_bytes": int(0.002 * HBM_BYTES_PER_S)}}
    assert core.merge_roofline_pct(rec) == pytest.approx(50.0)
    assert core.reader("merge_kernels_roofline.sweep")(rec) == pytest.approx(50.0)
    assert core.reader("device_idle_pct.merge")(rec) == pytest.approx(75.0)
    assert core.merge_roofline_pct({"profile": prof, "layers": {}}) is None


def test_per_flush_and_per_merge_readers():
    layers = {"flushes": 4, "flushed_changes": 100, "patch_loop_seconds": 0.8, "patch_assemble_seconds": 0.4,
              "host_seconds": 0.3, "launches": 50, "timings": [{"stage_s": 0.1, "digest_ms": 170.0},
                                                              {"stage_s": 0.3, "digest_ms": 168.0},
                                                              {"stage_s": 0.2, "digest_ms": 169.0}]}
    rec = {"layers": layers}
    assert core.reader("changes_per_flush.serve")(rec) == 25.0
    assert core.reader("patch_loop_ms_per_flush.serve")(rec) == pytest.approx(200.0)
    assert core.reader("patch_assemble_ms_per_flush.serve")(rec) == pytest.approx(100.0)
    assert core.reader("ingest_host_ms_per_merge.merge")(rec) == pytest.approx(6.0)
    assert core.reader("stage_ms_per_cohort.sweep")(rec) == pytest.approx(200.0)
    assert core.reader("digest_ms_per_cohort.sweep")(rec) == 169.0
    assert core.reader("changes_per_flush.serve")({"layers": {}}) is None


def _evt(name, start, end, device, mirrored=False):
    """A ``FunctionEvent`` on card 0; ``mirrored`` is the profiler's mark of a user annotation."""
    return types.SimpleNamespace(name=name, time_range=types.SimpleNamespace(start=start, end=end),
                                 device_type=f"DeviceType.{device}", device_index=0, is_user_annotation=mirrored)


def test_summarize_profile():
    events = [_evt("portbench.apply_changes", 0, 1000, "CPU"), _evt("aten::copy_", 100, 150, "CPU"),
              _evt("portbench.apply_changes", 0, 1000, "CUDA", mirrored=True),  # the span mirrored on the device: not busy
              _evt("k1", 100, 200, "CUDA"), _evt("k2", 150, 300, "CUDA"), _evt("k1", 700, 800, "CUDA")]
    prof = types.SimpleNamespace(events=lambda: events)
    s = core.summarize_profile(prof, 0.001)
    assert s["busy_s"] == pytest.approx(300e-6)
    assert s["by_name"] == pytest.approx({"k1": 200e-6, "k2": 150e-6})
    gaps = s["breakdown"]["idle_gaps"]
    assert gaps[0] == ["portbench.apply_changes", pytest.approx(400e-6)]
    assert [g[1] for g in gaps] == sorted((g[1] for g in gaps), reverse=True)
    assert core.idle_pct({"profile": s}) == pytest.approx(70.0)


def test_result_line_puts_checks_last_and_correct_from_them():
    rec = {"checks": [core.Check("a", 0, 0), core.Check("b", 1, 0)], "attempted": 3, "failed": 0,
           "device": {"platform": "gpu"}, "setup_s": 1.0}
    line = core.result_line(rec, [{"name": "setup_s", "unit": "s"}], False)
    assert list(line)[-1] == "checks" and line["correct"] is False
    assert line["metrics"] == {"setup_s": {"value": 1.0, "unit": "s"}}
    rec["checks"] = [core.Check("a", 0, 0)]
    assert core.result_line(rec, [], False)["correct"] is True
    rec["failed"] = 1
    assert core.result_line(rec, [], False)["correct"] is False
