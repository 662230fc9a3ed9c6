"""Scalar exact-semantics document engine (the host/oracle layer).

This sub-package re-expresses the reference's CRDT semantics
(reference src/micromerge.ts + peritext.ts) as plain Python with no tensor-library
dependency.  It serves three roles in the framework:

1. **Semantic oracle** for differential testing of the device kernels (every
   tensorized codepath must agree with this one, byte for byte).
2. **Interactive front-end**: op generation for live editing sessions goes
   through this layer (the ``change()`` path); the batched device engine is the
   merge/replay data plane.
3. **Wire-format authority**: ``Change`` dicts produced here JSON-serialize to
   the reference's exact change format (micromerge.ts:60-71), so reference
   failure traces replay directly.
"""
from peritext_tpu_torch.oracle.doc import (
    Doc,
    HEAD,
    ObjectStore,
    ROOT,
    accumulate_patches,
    add_characters_to_spans,
    get_list_element_id,
    get_text_with_formatting,
    ops_to_marks,
)

__all__ = [
    "Doc",
    "HEAD",
    "ObjectStore",
    "ROOT",
    "accumulate_patches",
    "add_characters_to_spans",
    "get_list_element_id",
    "get_text_with_formatting",
    "ops_to_marks",
]
