"""The port's package surface (``peritext_tpu_torch/__init__.py``) against
the JAX package's (``peritext_tpu/__init__.py``): ``__all__`` name for
name with ``TorchDoc``/``TorchUniverse`` for ``TpuDoc``/``TpuUniverse``,
a dynamic ``ALL_MARKS``, ``obs`` as the port's telemetry module, the lazy
bridge names, ``__version__``, and ``ops.state.visible_text`` equal to
JAX's on the same state."""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import peritext_tpu
import peritext_tpu_torch
from peritext_tpu.ops import TpuUniverse
from peritext_tpu.ops.state import visible_text as jvisible_text
from peritext_tpu_torch import TorchUniverse, bridge, schema
from peritext_tpu_torch.ops.state import index_state, visible_text
from peritext_tpu_torch.oracle import Doc
from peritext_tpu_torch.runtime import telemetry

REPO = Path(__file__).resolve().parents[1]
ENGINE_NAMES = {"TpuDoc": "TorchDoc", "TpuUniverse": "TorchUniverse"}
PORT_ONLY = {"DocState", "state_from_numpy", "state_to_numpy", "wcache_from_numpy", "wcache_to_numpy"}


def test_all_is_the_jax_packages_with_the_torch_engines():
    want = [ENGINE_NAMES.get(n, n) for n in peritext_tpu.__all__]
    got = peritext_tpu_torch.__all__
    assert got[: len(want)] == want
    assert set(got[len(want):]) == PORT_ONLY
    for name in got:
        assert getattr(peritext_tpu_torch, name) is not None, name
    assert peritext_tpu_torch.__version__ == peritext_tpu.__version__ == "0.1.0"
    assert peritext_tpu_torch.TorchDoc.__module__ == "peritext_tpu_torch.ops.doc"
    assert peritext_tpu_torch.TorchUniverse.__module__ == "peritext_tpu_torch.ops.universe"
    assert peritext_tpu_torch.Doc.__module__ == "peritext_tpu_torch.oracle.doc"
    with pytest.raises(AttributeError):
        peritext_tpu_torch.TpuUniverse


@pytest.fixture
def restore_marks():
    saved = {k: getattr(schema, k) for k in (
        "ALL_MARKS", "NUM_MARK_TYPES", "INCLUSIVE_BY_ID", "ALLOW_MULTIPLE_BY_ID")}
    spec, ids = dict(schema.MARK_SPEC), dict(schema.MARK_TYPE_ID)
    yield
    for k, v in saved.items():
        setattr(schema, k, v)
    schema.MARK_SPEC.clear()
    schema.MARK_SPEC.update(spec)
    schema.MARK_TYPE_ID.clear()
    schema.MARK_TYPE_ID.update(ids)


def test_all_marks_tracks_register_mark_type(restore_marks):
    before = peritext_tpu_torch.ALL_MARKS
    assert before == tuple(peritext_tpu.ALL_MARKS)
    peritext_tpu_torch.register_mark_type("highlight", inclusive=True)
    assert peritext_tpu_torch.ALL_MARKS == before + ("highlight",)
    assert peritext_tpu_torch.MARK_TYPE_ID["highlight"] == len(before)
    assert "highlight" in peritext_tpu_torch.MARK_SPEC
    assert peritext_tpu_torch.ALL_MARKS is schema.ALL_MARKS


def test_obs_is_the_ports_telemetry_module():
    assert peritext_tpu_torch.obs is telemetry
    assert peritext_tpu.obs is not telemetry


def test_bridge_names_are_the_ports_bridge_objects():
    for name in ("Editor", "EditorNetwork", "RemoteChangeHighlighter", "editor_doc_from_spans",
                 "editor_doc_text", "content_pos_from_editor_pos", "initialize_docs"):
        assert getattr(peritext_tpu_torch, name) is getattr(bridge, name), name
        assert getattr(peritext_tpu_torch, name) is not getattr(peritext_tpu, name), name


def test_doc_and_accumulate_patches_are_the_ports_oracle():
    alice = peritext_tpu_torch.Doc("alice")
    _, patches = alice.change([
        {"path": [], "action": "makeList", "key": "text"},
        {"path": ["text"], "action": "insert", "index": 0, "values": list("Hello")},
    ])
    assert peritext_tpu_torch.accumulate_patches(patches) == alice.get_text_with_formatting(["text"])


def _two_writer_batches():
    a, b = Doc("a"), Doc("b")
    g, _ = a.change([
        {"path": [], "action": "makeList", "key": "text"},
        {"path": ["text"], "action": "insert", "index": 0, "values": list("visible text, \U0001F600 ok")},
    ])
    b.apply_change(g)
    ca, _ = a.change([{"path": ["text"], "action": "delete", "index": 3, "count": 4}])
    cb, _ = b.change([{"path": ["text"], "action": "insert", "index": 8, "values": list("XY")}])
    return [[g, ca, cb], [g, cb, ca]]


def test_visible_text_equals_jax_on_one_state():
    batches = _two_writer_batches()
    port = TorchUniverse(["r0", "r1"], device="cpu")
    port.apply_changes(batches)
    tpu = TpuUniverse(["r0", "r1"])
    tpu.apply_changes(batches)
    from peritext_tpu.ops.state import index_state as jindex

    for r in range(2):
        got = visible_text(index_state(port.states, r))
        assert got == jvisible_text(jindex(tpu.states, r))
        assert got == port.texts()[r]
    assert np.asarray(port.states.deleted).any()  # tombstones are skipped


def test_importing_the_package_loads_no_jax():
    code = (
        "import sys\n"
        "import peritext_tpu_torch as p\n"
        "for name in p.__all__:\n"
        "    getattr(p, name)\n"
        "from peritext_tpu_torch.runtime import native_codec\n"
        "native_codec.encode_columns([[1, 2, 3]])\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'peritext_tpu'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
