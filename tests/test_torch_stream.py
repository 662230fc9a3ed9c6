"""The port's cohort stream (peritext_tpu_torch/parallel/stream.py) against
the JAX package's stream and its resident sorted merge, on the same seeded
numpy inputs (tests/test_stream.py's fixture): every cohort size, a padded
tail, depth 1, no digest, no state readback, the budget arithmetic, the
device_launch breaker, a failed launch's trace lanes, the kernels at C =
32768 (past one block, within the clusters' limit), and the sorted leg a
capacity past the kernels' limit takes.  Byte-equal throughout: all 13
DocState fields and the digests as uint32."""
import json
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

from peritext_tpu.bench.workloads import build_device_batch, make_merge_workload
from peritext_tpu.ops import kernels as JK
from peritext_tpu.ops.encode import prepare_sorted_batch
from peritext_tpu.parallel import stream as jstream
from peritext_tpu.schema import allow_multiple_array
from peritext_tpu_torch.ops.state import FIELDS
from peritext_tpu_torch.parallel import stream as S
from peritext_tpu_torch.runtime import faults, health, telemetry
from peritext_tpu_torch.runtime.health import BreakerOpenError

REPO = Path(__file__).resolve().parents[1]
REPLICAS = 10


@pytest.fixture(scope="module")
def merge_inputs():
    """A 10-replica marked-merge batch (4 distinct streams tiled) and the
    JAX resident single-launch merge with its digests."""
    workload = make_merge_workload(doc_len=120, ops_per_merge=24, num_streams=4,
                                   with_marks=True, seed=7)
    batch = build_device_batch(workload, REPLICAS, 512, 64)
    sp = prepare_sorted_batch([batch["text_ops"][r] for r in range(REPLICAS)])
    inputs = {
        "states": jax.tree.map(np.asarray, batch["states"]),
        "text": sp["text"],
        "rounds": sp["rounds"],
        "num_rounds": sp["num_rounds"],
        "marks": np.asarray(batch["mark_ops"]),
        "ranks": np.asarray(batch["ranks"]),
        "bufs": sp["bufs"],
        "maxk": sp["maxk"],
    }
    resident = JK.merge_step_sorted_batch(
        batch["states"], *(jax.numpy.asarray(inputs[k]) for k in ("text", "rounds")),
        sp["num_rounds"], *(jax.numpy.asarray(inputs[k]) for k in ("marks", "ranks", "bufs")),
        sp["maxk"],
    )
    digests = np.asarray(JK.convergence_digest_batch(
        resident, jax.numpy.asarray(inputs["ranks"]), jax.numpy.asarray(allow_multiple_array())
    ))
    return inputs, jax.tree.map(np.asarray, resident), digests


@pytest.fixture(autouse=True)
def clean_planes():
    for plane in (faults, health, telemetry):
        plane.reset()
    yield
    for plane in (faults, health, telemetry):
        plane.reset()


def _args(inputs):
    return (inputs["states"], inputs["text"], inputs["rounds"], inputs["num_rounds"],
            inputs["marks"], inputs["ranks"], inputs["bufs"], inputs["maxk"])


def _stream(inputs, **kw):
    return S.stream_merge_sorted(*_args(inputs), device="cpu", **kw)


def assert_states_equal(got, want):
    """Every field, dtype included (uint32 mask words, as JAX holds them)."""
    for f in FIELDS:
        w = np.asarray(getattr(want, f))
        assert got[f].dtype == w.dtype, f
        np.testing.assert_array_equal(got[f], w, err_msg=f)


@pytest.mark.parametrize("cohort", [4, 3, 10, 64])
def test_stream_matches_jax_stream_and_resident(merge_inputs, cohort):
    """Even cohorts, a padded tail (3 and 4 into 10), cohort == R and
    cohort > R reproduce JAX's resident merge and JAX's own stream."""
    inputs, resident, digests = merge_inputs
    out, dg, stats = _stream(inputs, cohort=cohort)
    j_out, j_dg, j_stats = jstream.stream_merge_sorted(*_args(inputs), cohort=cohort)
    assert dg.dtype == np.uint32
    np.testing.assert_array_equal(dg, digests)
    np.testing.assert_array_equal(dg, j_dg)
    assert_states_equal(out, resident)
    assert_states_equal(out, j_out)
    assert {k: stats[k] for k in j_stats} == j_stats
    assert stats["route"] == "kernels" and stats["capacity_routes"] == 0
    assert [t["lo"] for t in stats["timings"]] == list(range(0, REPLICAS, stats["cohort"]))


def test_stream_depth_one(merge_inputs):
    """depth=1 drains each cohort before the next launch: same bytes."""
    inputs, resident, digests = merge_inputs
    out, dg, stats = _stream(inputs, cohort=4, depth=1)
    np.testing.assert_array_equal(dg, digests)
    assert_states_equal(out, resident)
    assert stats["depth"] == 1 and stats["n_cohorts"] == 3


def test_stream_completion_token_without_digest(merge_inputs):
    """compute_digest=False: the digest slot carries post-merge lengths."""
    inputs, resident, _ = merge_inputs
    out, tokens, _ = _stream(inputs, cohort=4, compute_digest=False)
    j_out, j_tokens, _ = jstream.stream_merge_sorted(*_args(inputs), cohort=4, compute_digest=False)
    np.testing.assert_array_equal(tokens, np.asarray(resident.length).astype(np.uint32))
    np.testing.assert_array_equal(tokens, j_tokens)
    assert_states_equal(out, resident)


def test_stream_no_state_readback(merge_inputs):
    """readback_states=False: digests only (the digest-only sweep)."""
    inputs, _, digests = merge_inputs
    out, dg, _ = _stream(inputs, cohort=4, readback_states=False)
    assert out is None
    np.testing.assert_array_equal(dg, digests)


@pytest.mark.parametrize("compute_digest", [True, False])
def test_stream_takes_one_digest_call_a_cohort(merge_inputs, monkeypatch, compute_digest):
    """Each cohort's digest is one call of ``cuda_kernels.convergence_digest``
    (one launch of the digest kernel on the card); without digests there
    is none."""
    inputs, _, digests = merge_inputs
    calls = []
    real = S.convergence_digest

    def spy(states, ranks, multi):
        calls.append(states.chars.shape[0])
        return real(states, ranks, multi)

    monkeypatch.setattr(S, "convergence_digest", spy)
    _, dg, stats = _stream(inputs, cohort=4, readback_states=False, compute_digest=compute_digest)
    assert stats["n_cohorts"] == 3
    if not compute_digest:
        assert calls == []
        return
    np.testing.assert_array_equal(dg, digests)
    assert calls == [4, 4, 4]


def test_stream_takes_a_broadcast_population(merge_inputs):
    """A population that is a read-only broadcast view of one replica (how
    a north-star sweep holds 100k replicas on the host) streams without a
    copy of the population and gives the resident merge's rows."""
    inputs, resident, _ = merge_inputs
    bcast = {f: np.broadcast_to(np.asarray(getattr(inputs["states"], f))[:1],
                                np.asarray(getattr(inputs["states"], f)).shape) for f in FIELDS}
    assert all(np.array_equal(bcast[f], np.asarray(getattr(inputs["states"], f))) for f in FIELDS)
    out, _, _ = S.stream_merge_sorted(bcast, *_args(inputs)[1:], cohort=3, device="cpu")
    assert_states_equal(out, resident)


def test_cohort_budget_math():
    """The budget helpers compute from shapes alone and agree with the JAX
    package's: C=16384/M=1024 state is ~4.25 MiB a replica, the north-star
    shape C=16384/M=128 772,616 B; the cohort estimate scales linearly with
    devices and inversely with depth."""
    sb = S.state_bytes_per_replica(16384, 1024)
    assert abs(sb / 2**20 - 4.25) < 0.1
    assert S.state_bytes_per_replica(16384, 128) == 772_616
    for c, m in ((512, 64), (2048, 1024), (16384, 128), (16384, 1024)):
        assert S.state_bytes_per_replica(c, m) == jstream.state_bytes_per_replica(c, m)
        assert S.transient_bytes_per_replica(c, m, 64) == jstream.transient_bytes_per_replica(c, m, 64)
        for depth in (1, 2):
            assert S.cohort_for_budget(c, m, 64, depth=depth) == jstream.cohort_for_budget(c, m, 64, depth=depth)
    one = S.cohort_for_budget(16384, 1024, ops_len=64, depth=2, n_devices=1)
    eight = S.cohort_for_budget(16384, 1024, ops_len=64, depth=2, n_devices=8)
    shallow = S.cohort_for_budget(16384, 1024, ops_len=64, depth=1, n_devices=1)
    assert eight == pytest.approx(8 * one, rel=0.01)
    assert shallow == pytest.approx(2 * one, rel=0.01)
    assert 2 * one * sb < 0.9 * 16 * 2**30
    with pytest.raises(ValueError, match="multiple of 32"):
        S.state_bytes_per_replica(512, 48)


class FakeClock:
    """Injectable monotonic clock: the tests drive cool-down expiry."""

    def __init__(self) -> None:
        self.now = 0.0

    def __call__(self) -> float:
        return self.now


def test_stream_fastfails_under_open_breaker_and_recovers(merge_inputs):
    """An OPEN device_launch breaker fast-fails the sweep with
    BreakerOpenError (no degrade path at population scale); after the
    cool-down the first cohort runs as the canary and drains before the
    next launch, the circuit closes, and the sweep equals a breaker-free
    run, with the breaker counts tests/test_health.py holds the JAX
    stream to."""
    inputs, _, digests = merge_inputs
    clock = FakeClock()
    br = health.install(health.HealthPlan(clock=clock)).site(
        "device_launch", threshold=1, cooldown=3.0, jitter=0.0)
    br.record_failure()  # trip
    with pytest.raises(BreakerOpenError):
        _stream(inputs, cohort=2, readback_states=False)
    assert br.stats["fastfails"] == 1
    clock.now += 4.0
    _, got, stats = _stream(inputs, cohort=2, readback_states=False)
    assert br.state == health.CLOSED and br.stats["closes"] == 1
    assert br.stats["successes"] == stats["n_cohorts"] == 5
    np.testing.assert_array_equal(got, digests)


def test_failed_launch_raises_and_closes_every_lane(merge_inputs, tmp_path, monkeypatch):
    """A merge that fails on the third cohort fails the sweep: the failed
    cohort's lane and the launched-but-undrained ones all end (the trace
    report finds no open lane), and the stream's spans are there."""
    inputs, _, _ = merge_inputs
    calls = []
    real = S.merge_step_full

    def failing(*args):
        calls.append(1)
        if len(calls) == 3:
            raise RuntimeError("text_phase kernel launch failed: injected")
        return real(*args)

    monkeypatch.setattr(S, "merge_step_full", failing)
    trace = tmp_path / "trace.jsonl"
    telemetry.enable(trace=str(trace))
    with pytest.raises(RuntimeError, match="injected"):
        _stream(inputs, cohort=2, readback_states=False, depth=2)
    telemetry.flush_trace()
    events = [json.loads(line) for line in trace.read_text().splitlines() if line.strip()]
    names = {e.get("name") for e in events}
    assert {"stream.launch", "stream.drain", "stream.abort"} <= names
    proc = subprocess.run([sys.executable, str(REPO / "scripts" / "trace_report.py"), str(trace)],
                          capture_output=True, text=True, timeout=60)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "problems=0" in proc.stdout


def test_capacity_leg_takes_the_sorted_merge(merge_inputs, monkeypatch):
    """A capacity past the kernels' limit (monkeypatched down to 256 under
    the fixture's 512) streams through the sorted merge, counted once per
    cohort in ``capacity_routes``, with the same bytes."""
    inputs, resident, digests = merge_inputs
    monkeypatch.setattr(S, "kernel_capacity_limit", lambda words: 256)
    out, dg, stats = _stream(inputs, cohort=4)
    assert stats["route"] == "sorted" and stats["capacity_routes"] == stats["n_cohorts"] == 3
    np.testing.assert_array_equal(dg, digests)
    assert_states_equal(out, resident)


def test_stream_past_16384_takes_the_kernels(merge_inputs):
    """Under the real limit the fixture's states grown to C = 32768 stream
    through the kernels' merge (their cluster form on the card), with no
    capacity route, byte-equal to JAX's resident merge at that capacity."""
    inputs, _, _ = merge_inputs
    cap, c0 = 32768, inputs["states"].elem_ctr.shape[-1]

    def grow(f, a):
        if f in ("elem_ctr", "elem_act", "deleted", "chars"):
            return np.pad(a, ((0, 0), (0, cap - c0)))
        if f in ("bnd_def", "bnd_mask"):
            return np.pad(a, ((0, 0), (0, 2 * (cap - c0))) + ((0, 0),) * (a.ndim - 2))
        return a

    grown = dict(inputs, states=type(inputs["states"])(
        **{f: grow(f, getattr(inputs["states"], f)) for f in FIELDS}))
    out, dg, stats = _stream(grown, cohort=4)
    assert stats["route"] == "kernels" and stats["capacity_routes"] == 0
    jnp_ = jax.numpy
    resident = JK.merge_step_sorted_batch(
        jax.tree.map(jnp_.asarray, grown["states"]),
        *(jnp_.asarray(grown[k]) for k in ("text", "rounds")), grown["num_rounds"],
        *(jnp_.asarray(grown[k]) for k in ("marks", "ranks", "bufs")), grown["maxk"],
    )
    digests = np.asarray(JK.convergence_digest_batch(
        resident, jnp_.asarray(grown["ranks"]), jnp_.asarray(allow_multiple_array())
    ))
    np.testing.assert_array_equal(dg, digests)
    assert_states_equal(out, jax.tree.map(np.asarray, resident))

@pytest.mark.parametrize("stream", [False, True])
def test_fleet_demo(stream, capsys):
    """The port's fleet demo, resident and streamed (cohorts of 5 over 14
    replicas, a padded tail), ends with every schedule class converged."""
    from peritext_tpu_torch.examples import fleet_demo

    args = ["--replicas", "14", "--rounds", "3", "--device", "cpu"]
    fleet_demo.main(args + (["--cohort", "5"] if stream else []))
    out = capsys.readouterr().out
    assert out.count("CONVERGED") == 4 and "DIVERGED" not in out
    assert ("3 cohorts on the kernels route" in out) == stream
