"""The text kernel's forms, chosen from the capacity C and the op rows L
alone: the plane form at C <= 8192, the piece form past it up to C =
16384 where its piece table fits a quarter of an SM's shared memory, the
cluster form past one block.  Its shared-memory count, its launch
counter, the CPU route (the plain version, nothing counted), the kernel
names the benchmark's roofline reads, and the resident fleet's text
batches it is measured on.  The piece kernel itself runs only on the card
(``tests/test_torch_cuda.py -k piece``).  No JAX."""
import re

import numpy as np
import pytest
import torch

from peritext_tpu_torch.bench.workloads import RESIDENT_TEXT_SHAPES, resident_text_batch, text_row_mix
from peritext_tpu_torch.ops import _build, cuda_kernels
from peritext_tpu_torch.ops import kernels as K


@pytest.mark.parametrize("capacity,num_ops,form", [
    (2048, 64, "plane"), (2048, 512, "plane"), (2048, 4096, "plane"),
    (4096, 64, "plane"), (4096, 1024, "plane"),
    (8192, 64, "plane"), (8192, 512, "plane"),
    (8196, 64, "piece"), (12000, 256, "piece"),
    (16384, 0, "piece"), (16384, 64, "piece"), (16384, 256, "piece"), (16384, 512, "piece"),
    (16384, 1024, "plane"), (16384, 4096, "plane"),
    (32768, 64, "cluster"), (32768, 1024, "cluster"), (131072, 512, "cluster"),
])
def test_text_form_follows_capacity_and_rows(capacity, num_ops, form):
    assert cuda_kernels.text_form(capacity, num_ops) == form


def test_piece_form_fits_four_replicas_an_sm_up_to_512_rows():
    """The piece form's rule is its footprint against a quarter of an SM:
    every L the universe buckets up to 512 fits, 1024 does not."""
    limit = cuda_kernels.PIECE_SMEM_LIMIT
    assert limit == cuda_kernels.MAX_SHARED_BYTES // 4
    for num_ops in (8, 16, 32, 64, 128, 256, 512):
        assert cuda_kernels.text_piece_smem_bytes(16384, num_ops) <= limit
    assert cuda_kernels.text_piece_smem_bytes(16384, 1024) > limit


@pytest.mark.parametrize("num_ops,want", [
    # pieces 16 (2L + 4), records 16 L, key slots 16 (T + 1) with T the
    # power of two >= 2L (at least 32), tombstone words 4 (C / 32 + 1),
    # piece starts 4 (2L + 5), scratch 4 * 64.
    (64, 16 * 132 + 16 * 64 + 16 * 129 + 4 * 513 + 4 * 133 + 256),
    (256, 16 * 516 + 16 * 256 + 16 * 513 + 4 * 513 + 4 * 517 + 256),
    (512, 16 * 1028 + 16 * 512 + 16 * 1025 + 4 * 513 + 4 * 1029 + 256),
])
def test_piece_shared_memory_matches_a_hand_count(num_ops, want):
    assert cuda_kernels.text_piece_smem_bytes(16384, num_ops) == want
    assert want == {64: 8040, 256: 24936, 512: 47464}[num_ops]


def test_piece_shared_memory_grows_with_rows_not_capacity():
    at = cuda_kernels.text_piece_smem_bytes
    assert at(16384, 256) - at(8200, 256) == 4 * (16384 // 32 - (8200 + 31) // 32)
    assert at(16384, 512) - at(16384, 256) == 88 * 256  # 32 B pieces, 16 records, 32 keys, 8 starts a row
    assert at(16384, 512) < cuda_kernels.text_phase_smem_bytes(16384) // 4


def test_reset_launch_counts_clears_piece_launches():
    cuda_kernels.PIECE_LAUNCHES["text_phase"] = 5
    cuda_kernels.LAUNCHES["text_phase"] = 5
    cuda_kernels.reset_launch_counts()
    assert cuda_kernels.PIECE_LAUNCHES == {"text_phase": 0}
    assert cuda_kernels.LAUNCHES == {"text_phase": 0, "mark_phase": 0, "digest": 0}


@pytest.mark.parametrize("shape", ["round", "genesis"])
def test_cpu_route_at_a_piece_shape_is_the_plain_version(shape):
    """On CPU tensors at C = 16384 (a piece-form shape on the card) the
    wrapper returns the plain version's outputs and counts no launch."""
    b = resident_text_batch(shape, 2, 3)
    args = [b[k] for k in ("elem_ctr", "elem_act", "deleted", "chars", "length", "text_ops", "ranks", "char_buf")]
    assert cuda_kernels.text_form(16384, b["text_ops"].shape[1]) == "piece"
    cuda_kernels.reset_launch_counts()
    got = cuda_kernels.text_phase(*args)
    want = K.text_phase_plain(*args)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
    assert cuda_kernels.PIECE_LAUNCHES == {"text_phase": 0}
    assert cuda_kernels.LAUNCHES == {"text_phase": 0, "mark_phase": 0, "digest": 0}


def test_every_text_kernel_name_holds_text_phase():
    """The benchmark's hand-kernel roofline sums the device time of kernels
    whose names hold ``text_phase`` or ``mark_phase``: each kernel of
    ``csrc/text_phase.cu``, the piece form's included, carries it."""
    src = (_build.CSRC_DIR / "text_phase.cu").read_text()
    names = re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?(\w+)", src)
    assert names == ["text_phase_kernel", "text_phase_piece_kernel"]
    assert all("text_phase" in n for n in names)


@pytest.mark.parametrize("shape", sorted(RESIDENT_TEXT_SHAPES))
def test_resident_text_batches_have_the_fleets_row_counts(shape):
    """Each replica of a resident batch has its shape's inserts, runs and
    deletes among L rows; the genesis inserts 10,000 chars into an empty
    document, the others reference live elements of a 10,000-char one."""
    counts = RESIDENT_TEXT_SHAPES[shape]
    b = resident_text_batch(shape, 3, 11)
    kind = b["text_ops"][..., K.K_KIND]
    assert b["text_ops"].shape == (3, counts["num_ops"], K.OP_FIELDS)
    for k, name in ((K.KIND_INSERT, "inserts"), (K.KIND_INSERT_RUN, "runs"), (K.KIND_DELETE, "deletes")):
        assert ((kind == k).sum(dim=1) == counts[name]).all(), name
    mix = text_row_mix(b["text_ops"], b["char_buf"])
    if shape == "genesis":
        assert (b["length"] == 0).all() and "chars inserted 10000-10000" in mix
    else:
        assert (b["length"] == 10000).all()
        ec = b["elem_ctr"].numpy()
        ids = set(zip(ec[0, :10000].tolist(), b["elem_act"][0, :10000].tolist()))
        assert len(ids) == 10000  # unique ids
        ops = b["text_ops"][0].numpy()
        refs = {(int(o[K.K_REF_CTR]), int(o[K.K_REF_ACT])) for o in ops if o[K.K_KIND] != K.KIND_PAD}
        assert len(refs & ids) > counts["deletes"] // 2
    assert np.array_equal(resident_text_batch(shape, 3, 11)["text_ops"].numpy(), b["text_ops"].numpy())
