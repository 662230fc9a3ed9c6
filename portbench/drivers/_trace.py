"""The traced slice of a window: ``torch.profiler`` over a steady part of
it, with the merge spy installed, and the harness's own spans around the
calls into the port (``torch.profiler.record_function``)."""
from __future__ import annotations

import contextlib
import time
from typing import Any, Dict, Optional

from portbench import core
from portbench.roofline import MergeSpy


def warm_profiler(device: str) -> None:
    """Start and stop the profiler once in set-up: its first start
    initialises the device tracer, which took seconds on the card and, in
    an open loop, left the generator behind its schedule."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    if device == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts):
        x = torch.ones(1, device=device) + 1
        if device == "cuda":
            torch.cuda.synchronize()
    del x


class Slice:
    """``with Slice(on, device, *modules) as s:`` profiles the body when
    ``on``; afterwards ``s.profile`` is the summary (``core.summarize_profile``)
    and ``s.spy`` the merges it saw.  With ``host=False`` only the device's
    activity is traced, which leaves the host's pace all but untouched.
    ``cards`` is how many cards the cell uses: each is synchronized as the
    slice opens and closes, and each is reckoned in the summary."""

    def __init__(self, on: bool, device: str, *spy_modules, host: bool = True, cards: int = 1):
        self.on = on
        self.device = device
        self.host = host
        self.cards = cards
        self.spy = MergeSpy(*spy_modules)
        self._summary: Optional[Dict[str, Any]] = None
        self._done = False
        self._stack = contextlib.ExitStack()

    def span(self, name: str):
        if not self.on:
            return contextlib.nullcontext()
        import torch

        return torch.profiler.record_function(f"portbench.{name}")

    def __enter__(self) -> "Slice":
        if not self.on:
            return self
        import torch

        acts = [torch.profiler.ProfilerActivity.CPU] if self.host else []
        if self.device == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
            self._synchronize()
        self._prof = self._stack.enter_context(torch.profiler.profile(activities=acts))
        self._stack.enter_context(self.spy)
        self._t = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        if not self.on:
            return
        if self.device == "cuda":
            self._synchronize()
        self._wall = time.perf_counter() - self._t
        self._stack.close()
        self._done = exc[0] is None

    def _synchronize(self) -> None:
        import torch

        for i in range(self.cards):
            torch.cuda.synchronize(i)

    @property
    def profile(self) -> Optional[Dict[str, Any]]:
        """The summary, worked out at first use: after the window, so that
        reading a large trace never holds up an open loop's generator."""
        if self._summary is None and self._done:
            self._summary = core.summarize_profile(self._prof, self._wall, cards=self.cards)
        return self._summary
