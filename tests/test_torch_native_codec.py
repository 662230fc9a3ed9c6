"""The port's native change-log codec (``peritext_tpu_torch/runtime/
native_codec.py`` over ``peritext_tpu_torch/csrc/native_codec.cpp``)
against the JAX package's (``peritext_tpu/runtime/native_codec.py``).

The JAX package's codec tests run over the port; the port's bytes, native
and Python, equal the JAX codec's on the same seeded matrices; a
hypothesis round trip; the library is built into ``peritext_tpu_torch/
build/`` and never under ``native/``; and two processes building it at
once both load a working library.  Tolerance is 0: the format is bytes.
"""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from peritext_tpu.runtime import native_codec as jcodec
from peritext_tpu_torch.fuzz import fuzz
from peritext_tpu_torch.ops import _build
from peritext_tpu_torch.runtime.log import ChangeLog, log_columns
from peritext_tpu_torch.runtime.native_codec import (
    decode_columns,
    encode_columns,
    library_path,
    native_available,
)

REPO = Path(__file__).resolve().parents[1]
SHAPES = [(15, 0), (15, 1), (3, 1000), (16, 257)]


def _matrix(shape, seed=7, bound=2**31):
    rng = np.random.default_rng(seed)
    return rng.integers(-bound, bound, size=shape, dtype=np.int64).astype(np.int32)


# -- the JAX package's codec tests, over the port ----------------------------


@pytest.mark.parametrize("shape", SHAPES)
def test_codec_round_trip(shape):
    matrix = _matrix(shape)
    data = encode_columns(matrix)
    out = decode_columns(data, *shape)
    assert (out == matrix).all()


def test_native_and_python_formats_are_identical():
    if not native_available():
        pytest.skip("native toolchain unavailable")
    matrix = _matrix((15, 500), seed=3, bound=10**6)
    native = encode_columns(matrix)
    python = encode_columns(matrix, force_python=True)
    assert native == python
    assert (decode_columns(native, 15, 500, force_python=True) == matrix).all()
    assert (decode_columns(python, 15, 500) == matrix).all()


def test_codec_compresses_monotone_columns():
    col = np.arange(10_000, dtype=np.int32).reshape(1, -1)
    data = encode_columns(col)
    assert len(data) < col.size * 4 / 3


@pytest.mark.parametrize("force_python", [False, True])
def test_decode_rejects_malformed(force_python):
    # The native coder reports trailing bytes as a malformed stream, as the
    # JAX package's does; both are ValueError.
    with pytest.raises(ValueError, match="malformed varint stream"):
        decode_columns(b"\xff\xff\xff\xff\xff\xff", 1, 1, force_python=force_python)
    with pytest.raises(ValueError):
        decode_columns(b"\x00\x00", 1, 1, force_python=force_python)
    with pytest.raises(ValueError, match="trailing bytes"):
        decode_columns(b"\x00", 0, 3, force_python=force_python)


def test_encode_rejects_a_non_matrix():
    with pytest.raises(ValueError, match="2-D"):
        encode_columns(np.zeros(4, np.int32))


def test_change_log_binary_round_trip():
    result = fuzz(iterations=60, seed=9)
    log = result["log"]
    data = log.to_bytes()
    _, matrix = log_columns(log)
    payload = encode_columns(matrix)
    assert data.endswith(payload)
    assert payload == encode_columns(matrix, force_python=True)
    assert (decode_columns(payload, *matrix.shape, force_python=True) == matrix).all()
    restored = ChangeLog.from_bytes(data)
    for actor in log.actors:
        assert restored.changes_for(actor) == log.changes_for(actor), actor
    assert restored.clock() == log.clock()
    as_json = json.dumps({a: log.changes_for(a) for a in log.actors}).encode()
    assert len(data) < len(as_json) * 0.75, (len(data), len(as_json))


def test_change_log_round_trips_nested_object_changes():
    """Nested-list inserts ride the row stream and multi-codepoint elements
    the JSON envelope; the restored log replays into the same document."""
    from peritext_tpu_torch.oracle import Doc
    from peritext_tpu_torch.runtime.sync import apply_changes

    log = fuzz(iterations=80, seed=4, nested=True)["log"]
    observer = Doc("observer")
    apply_changes(observer, log.all_changes())
    weird, _ = observer.change([
        {"path": [], "action": "makeList", "key": "wide"},
        {"path": ["wide"], "action": "insert", "index": 0, "values": ["ab", "c"]},
    ])
    log.record(weird)
    restored = ChangeLog.from_bytes(log.to_bytes())
    for actor in log.actors:
        assert restored.changes_for(actor) == log.changes_for(actor), actor
    replica = Doc("replay")
    apply_changes(replica, restored.all_changes())
    assert replica.root == observer.root
    assert replica.root["wide"] == ["ab", "c"]


# -- the port's bytes against the JAX codec's --------------------------------


@pytest.mark.parametrize("bound", [2**31, 10**6, 100])
@pytest.mark.parametrize("shape", SHAPES + [(16, 0), (1, 70_000)])
def test_bytes_equal_the_jax_codec(shape, bound):
    matrix = _matrix(shape, seed=shape[1] + bound % 97, bound=bound)
    port = encode_columns(matrix)
    assert port == encode_columns(matrix, force_python=True)
    assert port == jcodec.encode_columns(matrix, force_python=True)
    if jcodec.native_available():
        assert port == jcodec.encode_columns(matrix)
    assert (jcodec.decode_columns(port, *shape) == matrix).all()
    assert (decode_columns(jcodec.encode_columns(matrix), *shape) == matrix).all()


@settings(max_examples=40, deadline=None)
@given(
    data=st.lists(st.integers(-(2**31), 2**31 - 1), max_size=64),
    cols=st.integers(1, 4),
)
def test_codec_round_trip_property(data, cols):
    rows = len(data) // cols
    matrix = np.asarray(data[: rows * cols], np.int32).reshape(cols, rows)
    blob = encode_columns(matrix)
    assert (decode_columns(blob, cols, rows) == matrix).all()
    assert (decode_columns(blob, cols, rows, force_python=True) == matrix).all()
    assert blob == encode_columns(matrix, force_python=True)
    assert blob == jcodec.encode_columns(matrix, force_python=True)


@pytest.mark.parametrize("blob", [b"\x80\x80\x80\x80\x0f", b"\xff\xff\xff\xff\x7f", b"\x81\x00"])
def test_non_canonical_varints_decode_as_the_jax_codec(blob):
    """Varints the encoder never writes (over-long, bits past 32) decode
    the same in the port's native and Python coders and in JAX's."""
    want = jcodec.decode_columns(blob, 1, 1, force_python=True)
    assert (decode_columns(blob, 1, 1) == want).all()
    assert (decode_columns(blob, 1, 1, force_python=True) == want).all()


# -- where the library comes from --------------------------------------------


def test_library_is_built_in_the_port_build_dir():
    path = Path(library_path()).resolve()
    assert path.parent == _build.BUILD_DIR.resolve()
    assert path.name.startswith("native_codec-") and path.suffix == ".so"
    assert "native" not in path.relative_to(REPO).parts[:1]
    # The CUDA kernels' names do not hash the C++ source.
    src = _build.CSRC_DIR / "native_codec.cpp"
    assert src.exists()
    for name in _build.KERNELS:
        assert _build._library_path(name) == _build._hashed_path(
            name, _build.NVCC_FLAGS,
            [_build.CSRC_DIR / "common.cuh", _build.CSRC_DIR / f"{name}.cu"],
        )


def test_two_processes_building_at_once_both_load_a_working_library(tmp_path):
    """Two fresh processes build into an empty build directory at the same
    moment; each loads its library and round-trips a matrix, and the
    directory ends with one library and no temporary file."""
    pkg = tmp_path / "peritext_tpu_torch"
    (pkg / "csrc").mkdir(parents=True)
    (pkg / "csrc" / "native_codec.cpp").write_bytes(
        (REPO / "peritext_tpu_torch" / "csrc" / "native_codec.cpp").read_bytes())
    code = textwrap.dedent(f"""
        import sys, time
        from pathlib import Path
        import numpy as np
        from peritext_tpu_torch.ops import _build
        from peritext_tpu_torch.runtime import native_codec
        _build.CSRC_DIR = Path({str(pkg / "csrc")!r})
        _build.BUILD_DIR = Path({str(pkg / "build")!r})
        start = float(sys.argv[1])
        time.sleep(max(0.0, start - time.time()))
        assert native_codec.native_available()
        m = np.arange(-500, 500, dtype=np.int32).reshape(4, 250) * 7919
        blob = native_codec.encode_columns(m)
        assert blob == native_codec.encode_columns(m, force_python=True)
        assert (native_codec.decode_columns(blob, 4, 250) == m).all()
        print(native_codec.library_path())
    """)
    import time

    env = dict(os.environ, PYTHONPATH=str(REPO))
    start = str(time.time() + 3.0)
    procs = [subprocess.Popen([sys.executable, "-c", code, start], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for _ in range(2)]
    outs = [p.communicate(timeout=180) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
    paths = {out.strip() for out, _ in outs}
    assert len(paths) == 1 and Path(paths.pop()).parent == pkg / "build"
    assert [f.name for f in (pkg / "build").iterdir() if "tmp" in f.name] == []
    assert len(list((pkg / "build").glob("native_codec-*.so"))) == 1
