"""Give a run's seed its own content on a fixed shape of work.

Whatever sets the amount of work (which ops, how many, where they point)
comes from the traffic file's structure seeds, the same in every run, so
that runs with different seeds do the same work.  ``relabel`` then draws
from the run's seed what changes none of it: each character becomes
another under one permutation of the alphabet, each link another URL and
each comment id another, each map one to one.
"""
from __future__ import annotations

import random
from typing import Any, Dict

from portbench.gen.fuzzmix import EXAMPLE_URLS

ALPHABET = "abcdefghijklmnopqrstuvwxyz0123456789 "


class Relabel:
    def __init__(self, rng: random.Random):
        chars = list(ALPHABET)
        rng.shuffle(chars)
        self.chars = dict(zip(ALPHABET, chars))
        urls = list(EXAMPLE_URLS)
        rng.shuffle(urls)
        self.urls = dict(zip(EXAMPLE_URLS, urls))
        self.mask = rng.getrandbits(16)

    def _attrs(self, attrs: Dict[str, Any]) -> Dict[str, Any]:
        out = dict(attrs)
        if "url" in out:
            out["url"] = self.urls[out["url"]]
        if "id" in out:
            out["id"] = f"comment-{int(out['id'].rsplit('-', 1)[1], 16) ^ self.mask:04x}"
        return out

    def change(self, change: Dict[str, Any]) -> Dict[str, Any]:
        ops = []
        for op in change["ops"]:
            op = dict(op)
            if "value" in op and op.get("insert"):
                op["value"] = self.chars[op["value"]]
            if op.get("attrs"):
                op["attrs"] = self._attrs(op["attrs"])
            ops.append(op)
        return dict(change, ops=ops)

    def __call__(self, tree: Any) -> Any:
        """Every change in a nest of dicts and lists, relabelled (copies)."""
        if isinstance(tree, dict) and "ops" in tree:
            return self.change(tree)
        if isinstance(tree, dict):
            return {k: self(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [self(v) for v in tree]
        return tree
