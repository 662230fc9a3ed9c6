"""In-process publish/subscribe fan-out.

A copy of ``peritext_tpu/runtime/pubsub.py`` bound to the PyTorch port's
fault and telemetry planes.  ``publish`` fans an update out to every
subscriber except the sender, as the reference's ``Publisher`` does.

Delivery runs through the ``pubsub_deliver`` fault site (runtime/faults.py):
an active chaos plan can drop, duplicate, delay (wedge) or fail deliveries
per subscriber, and hold messages back for reordering — held messages
re-emerge ahead of later publishes to the same subscriber, so causal-gap
recovery (anti-entropy sync) is what restores convergence, exactly the
adversarial delivery model the CRDT claims to tolerate.
"""
from __future__ import annotations

import threading
from typing import Callable, Dict, Generic, TypeVar

from peritext_tpu_torch.runtime import faults
from peritext_tpu_torch.runtime import telemetry

T = TypeVar("T")


class Publisher(Generic[T]):
    def __init__(self) -> None:
        self._subscribers: Dict[str, Callable[[T], None]] = {}
        # One reentrant lock per publisher: every editor on this publisher
        # serializes doc mutation/delivery on it, so interval-driven (timer
        # thread) flushes can never interleave with local edits or with each
        # other — and a single shared lock cannot deadlock the way
        # per-editor locks would (delivery happens inside a flush).
        self.lock = threading.RLock()

    def subscribe(self, key: str, callback: Callable[[T], None]) -> None:
        if key in self._subscribers:
            raise ValueError(f"Subscriber already exists: {key}")
        self._subscribers[key] = callback

    def unsubscribe(self, key: str) -> None:
        if key not in self._subscribers:
            raise ValueError(f"Subscriber not found: {key}")
        del self._subscribers[key]

    def publish(self, sender: str, update: T) -> None:
        # Delivered vs dropped/duplicated/reordered/held-back: the chaos
        # outcomes mirror from FaultPlan._stat (faults.pubsub_deliver.*);
        # this site counts what actually reached callbacks.
        if not telemetry.enabled:
            # Disabled fast path: the untraced loop, one attr check paid.
            for key, callback in list(self._subscribers.items()):
                if key == sender:
                    continue
                for delivered in faults.filter_stream(
                    "pubsub_deliver", [update], stream=key
                ):
                    faults.fire("pubsub_deliver")
                    callback(delivered)
            return
        # Traced path: one causal lane per publish, a step per delivery
        # (the subscriber callbacks run with the lane scoped onto this
        # thread, so their ingest seams join it), terminated when the
        # fan-out completes.  e2e.publish_to_delivered is fed per delivery
        # — the reorder/holdback chaos makes per-receiver latency the
        # interesting number.
        telemetry.counter("pubsub.published")
        ctx = telemetry.flow("pubsub.publish", sender=sender)
        with telemetry.span("pubsub.publish", sender=sender):
            telemetry.flow_point(ctx)
            try:
                for key, callback in list(self._subscribers.items()):
                    if key == sender:
                        continue
                    # Per-subscriber stream: drop/dup/reorder decisions (and
                    # the holdback buffer) are independent per receiver, like
                    # real per-link network chaos.
                    for delivered in faults.filter_stream(
                        "pubsub_deliver", [update], stream=key
                    ):
                        faults.fire("pubsub_deliver")
                        telemetry.counter("pubsub.delivered")
                        with telemetry.span("pubsub.deliver", subscriber=key):
                            telemetry.flow_point(ctx, subscriber=key)
                            with telemetry.flowing((ctx,)):
                                callback(delivered)
                        telemetry.observe(
                            "e2e.publish_to_delivered",
                            telemetry.flow_elapsed_s(ctx),
                        )
            finally:
                # The lane finishes even when a subscriber raises — an
                # unterminated flow would read as a lost change.
                telemetry.flow_point(ctx, terminal=True)
