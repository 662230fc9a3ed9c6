"""The port's fuzzer and replay (peritext_tpu_torch/fuzz.py, replay.py)
against the JAX package's on the same seeds: every mode (the reference
profile, TorchDoc replicas, mixed engines, chaos, nested objects, growth,
the serving plane, the sharded plane with live migration and the
lifecycle) must generate the same change log, end on the same spans and
count the same protocol outcomes; a captured failure replays through the
port's replay; and the repo's ``traces/fail-seed3.json`` replays on the
oracle and on TorchDoc to the JAX replay's spans.  The serve modes build
their universes on the CPU (``device="cpu"``)."""
import functools
import os
import subprocess
import sys
from pathlib import Path

import pytest

from peritext_tpu import fuzz as jfuzz
from peritext_tpu import replay as jreplay
from peritext_tpu.runtime import faults as jfaults, health as jhealth, telemetry as jtelemetry
from peritext_tpu_torch import TorchDoc, replay
from peritext_tpu_torch.fuzz import DEFAULT_CHAOS_SPEC, FuzzError, fuzz
from peritext_tpu_torch.oracle import Doc
from peritext_tpu_torch.runtime import faults, health, telemetry

REPO = Path(__file__).resolve().parents[1]
CpuDoc = functools.partial(TorchDoc, device="cpu")


@pytest.fixture(autouse=True)
def clean_planes():
    planes = (faults, health, telemetry, jfaults, jhealth, jtelemetry)
    for plane in planes:
        plane.reset()
    yield
    for plane in planes:
        plane.reset()


def mixed(first=CpuDoc, second=Doc):
    engines = iter([first, second, first, second])
    return lambda actor: next(engines)(actor)


def queues(result):
    log = result["log"]
    return {a: log.changes_for(a) for a in log.actors}


def assert_same_run(got, want):
    assert queues(got) == queues(want)
    assert got["final_spans"] == want["final_spans"]
    assert got["iterations"] == want["iterations"]
    assert got["max_doc_len"] == want["max_doc_len"]
    for key in ("migrate_stats",):
        assert got[key] == want[key]
    if want["evict_stats"] is not None:
        drop = ("lifecycle",)
        assert {k: v for k, v in got["evict_stats"].items() if k not in drop} == {
            k: v for k, v in want["evict_stats"].items() if k not in drop}
    if want["serve_stats"] is not None:
        assert without_deadline_misses(got["serve_stats"]) == without_deadline_misses(want["serve_stats"])


def without_deadline_misses(stats):
    """Serve stats, each shard's included, less ``deadline_misses``: it
    counts wall-clock deadline expiries (JAX compiles while the port does
    not), so it is not a property of the run."""
    out = {k: v for k, v in stats.items() if k != "deadline_misses"}
    if "shards" in out:
        out["shards"] = [without_deadline_misses(s) for s in out["shards"]]
    return out


@pytest.mark.parametrize("case", [
    dict(seed=0, iterations=30),
    dict(seed=1, iterations=30),
    dict(seed=11, iterations=30, allow_comment_remove=True, check_patches=False),
    dict(seed=5, iterations=25, initial_text="The quick brown fox", max_insert_chars=4),
    dict(seed=7, iterations=25, nested=True),
    dict(seed=5, iterations=30, growth=True),
    dict(seed=4, iterations=30, chaos=DEFAULT_CHAOS_SPEC, chaos_quiesce=4),
], ids=["ref0", "ref1", "comment-remove", "larger-doc", "nested", "growth", "chaos"])
def test_oracle_modes_match_jax(case):
    assert_same_run(fuzz(**case), jfuzz.fuzz(**case))


@pytest.mark.parametrize("engine", ["torch", "mixed"])
@pytest.mark.parametrize("seed", [0, 3])
def test_torchdoc_engines_match_jax(engine, seed):
    """TorchDoc replicas (all, or alternating with the oracle) generate the
    oracle's changes: the run is the JAX oracle run, change for change."""
    factory = CpuDoc if engine == "torch" else mixed()
    got = fuzz(iterations=20, seed=seed, doc_factory=factory)
    assert_same_run(got, jfuzz.fuzz(iterations=20, seed=seed))
    assert any(isinstance(d, TorchDoc) for d in got["docs"])


def test_torchdoc_under_chaos_and_nested():
    got = fuzz(iterations=20, seed=6, doc_factory=mixed(), chaos=DEFAULT_CHAOS_SPEC, chaos_quiesce=5)
    assert_same_run(got, jfuzz.fuzz(iterations=20, seed=6, chaos=DEFAULT_CHAOS_SPEC, chaos_quiesce=5))
    got = fuzz(iterations=15, seed=21, doc_factory=mixed(Doc, CpuDoc), nested=True)
    assert_same_run(got, jfuzz.fuzz(iterations=15, seed=21, nested=True))


@pytest.mark.parametrize("case", [
    dict(seed=1, iterations=15, serve=True, chaos=DEFAULT_CHAOS_SPEC),
    dict(seed=2, iterations=15, serve=True, serve_shards=2, migrate_every=3, evict_every=4,
         chaos=DEFAULT_CHAOS_SPEC),
], ids=["serve", "sharded-migrate-evict"])
def test_serve_modes_match_jax(case):
    """The serving plane over a TorchUniverse, and the sharded plane with
    migrations and evictions, under chaotic delivery: the fuzz's own
    serve-vs-doc byte-identity checks pass, and the run (changes, spans,
    plane and protocol counts) is the JAX run's."""
    assert_same_run(fuzz(device="cpu", **case), jfuzz.fuzz(**case))


@pytest.mark.parametrize("seed", [3, 8])
def test_sharded_serve_on_torchdocs(seed):
    """More seeds of the sharded plane on the port alone (the JAX plane's
    compiles make each of its runs ~10 s): three shards, TorchDoc replicas,
    migrations racing evictions."""
    out = fuzz(iterations=24, seed=seed, doc_factory=mixed(), serve=True, serve_shards=3,
               migrate_every=2, evict_every=3, chaos=DEFAULT_CHAOS_SPEC, chaos_quiesce=4,
               device="cpu")
    ms, es = out["migrate_stats"], out["evict_stats"]
    assert ms["attempts"] >= 8 and es["attempts"] >= 5
    assert ms["migrations"] + ms["rollbacks"] + ms["skipped_cold"] == ms["attempts"]
    assert es["evictions"] + es["hydrations"] + es["rollbacks"] + es["skipped"] == es["attempts"]
    assert ms["migrations"] > 0 and es["evictions"] > 0


def test_captured_failure_replays_through_the_port(tmp_path):
    """A forced divergence is captured as a replayable change-log trace;
    the port's replay converges on it with oracle and TorchDoc replicas,
    to the spans JAX's replay gives."""

    class LyingDoc(Doc):
        def get_text_with_formatting(self, path):
            spans = super().get_text_with_formatting(path)
            if self.actor_id == "doc1" and spans:
                spans = [dict(s, text=s["text"] + "!") for s in spans]
            return spans

    with pytest.raises(FuzzError) as excinfo:
        fuzz(iterations=0, seed=3, doc_factory=LyingDoc, check_patches=False)
    path = tmp_path / "no" / "such" / "dir" / "fail-trace.json"
    excinfo.value.save(str(path))
    loaded = replay.load_trace(str(path))
    assert loaded["queues"] and set(loaded["queues"]) <= {"doc1", "doc2", "doc3"}
    spans = replay.assert_replay_converges(loaded["queues"])
    assert replay.assert_replay_converges(loaded["queues"], CpuDoc) == spans
    assert jreplay.assert_replay_converges(loaded["queues"]) == spans


@pytest.mark.parametrize("engine", ["oracle", "torch"])
def test_repo_trace_replays_to_the_jax_spans(engine):
    trace = replay.load_trace(str(REPO / "traces" / "fail-seed3.json"))
    factory = Doc if engine == "oracle" else CpuDoc
    spans = replay.assert_replay_converges(trace["queues"], factory)
    assert spans == jreplay.assert_replay_converges(trace["queues"])


def test_trace_session_and_concurrent_spec():
    """Event traces: a concurrent spec expanded to keystrokes and played by
    a TraceSession gives the JAX session's spans, on TorchDoc too."""
    ops1 = [{"action": "addMark", "startIndex": 0, "endIndex": 5, "markType": "strong"}]
    ops2 = [{"action": "insert", "index": 5, "values": list("!!")}]
    trace = replay.concurrent_spec_to_trace("Hello world", ops1, ops2)
    assert trace == jreplay.concurrent_spec_to_trace("Hello world", ops1, ops2)
    want = jreplay.TraceSession(["alice", "bob"])
    want.run(trace)
    for factory in (Doc, CpuDoc):
        session = replay.TraceSession(["alice", "bob"], factory)
        session.run(trace)
        assert session.spans() == want.spans()
        assert session.patches == want.patches


def _cli(*args, env=None):
    return subprocess.run(
        [sys.executable, "-m", "peritext_tpu_torch.fuzz", *args],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120,
    )


def test_cli_engines(tmp_path):
    """``python -m peritext_tpu_torch.fuzz N SEED --engine {oracle,torch,
    mixed} --device cpu`` runs; without ``--device`` the torch engines want
    the card and raise where there is none."""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    for engine in ("oracle", "torch", "mixed"):
        proc = _cli("12", "1", "--engine", engine, "--device", "cpu", "--report-every", "0",
                    "--trace-dir", str(tmp_path), env=env)
        assert proc.returncode == 0, proc.stdout + proc.stderr
        assert proc.stdout.strip().splitlines()[-1].startswith("ok: 12 iterations")
    proc = _cli("8", "2", "--serve", "--shards", "2", "--migrate-every", "2", "--chaos",
                "--device", "cpu", "--report-every", "0", env=env)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "migrate:" in proc.stdout and "telemetry:" in proc.stdout
    proc = _cli("4", "0", "--engine", "torch", "--report-every", "0",
                env=dict(env, CUDA_VISIBLE_DEVICES=""))
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr
