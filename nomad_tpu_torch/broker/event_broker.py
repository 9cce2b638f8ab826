"""Event broker — in-memory pub/sub of state-change events.

Reference: nomad/stream/event_broker.go (:30-48) with its ring-buffer
eventBuffer and per-subscriber subscriptions feeding ``/v1/event/stream``
NDJSON (nomad/stream/ndjson.go). Publishers are the server's apply paths
(the reference publishes from state-store txn hooks, state/events.go).
"""

from __future__ import annotations

import itertools
import json
import threading
from dataclasses import dataclass, field
from typing import Iterator, Optional

DEFAULT_BUFFER_SIZE = 4096

TOPIC_JOB = "Job"
TOPIC_EVAL = "Evaluation"
TOPIC_ALLOC = "Allocation"
TOPIC_NODE = "Node"
TOPIC_DEPLOYMENT = "Deployment"


@dataclass(slots=True)
class Event:
    topic: str
    type: str
    key: str  # job id / node id / alloc id ...
    namespace: str = "default"
    index: int = 0
    payload: dict = field(default_factory=dict)
    # broker-assigned monotonic sequence — several events can share one
    # state index (e.g. a batched client sync), so subscribers track seq,
    # never index, to avoid missing same-index events published later
    seq: int = 0

    def to_json(self) -> str:
        return json.dumps(
            {
                "Topic": self.topic,
                "Type": self.type,
                "Key": self.key,
                "Namespace": self.namespace,
                "Index": self.index,
                "Payload": self.payload,
            }
        )


class EventBroker:
    def __init__(self, size: int = DEFAULT_BUFFER_SIZE):
        self._lock = threading.Condition()
        self.size = size
        self._buf: list[Event] = []
        self._seq = itertools.count(1)

    def publish(self, events: list[Event], index: int) -> None:
        with self._lock:
            for ev in events:
                ev.index = index
                ev.seq = next(self._seq)
                self._buf.append(ev)
            if len(self._buf) > self.size:
                del self._buf[: len(self._buf) - self.size]
            self._lock.notify_all()

    def subscribe(
        self,
        topics: Optional[dict[str, list[str]]] = None,
        from_index: int = 0,
    ) -> "Subscription":
        """``topics`` maps topic → keys ("*" for all), as in the reference's
        SubscribeRequest; None subscribes to everything."""
        return Subscription(self, topics, from_index)

    def _collect(self, topics, after_seq: int) -> list[Event]:
        out = []
        for ev in self._buf:
            if ev.seq <= after_seq:
                continue
            if topics:
                keys = topics.get(ev.topic) or topics.get("*")
                if keys is None:
                    continue
                if "*" not in keys and ev.key not in keys:
                    continue
            out.append(ev)
        return out


class Subscription:
    def __init__(self, broker: EventBroker, topics, from_index: int):
        self.broker = broker
        self.topics = topics
        self.closed = False
        # map the caller's index cursor to an internal seq cursor
        with broker._lock:
            self.last_seq = max(
                (ev.seq for ev in broker._buf if ev.index <= from_index),
                default=0,
            )

    def next_events(self, timeout: float = 1.0) -> list[Event]:
        """Block until events newer than the cursor arrive (or timeout)."""
        with self.broker._lock:
            events = self.broker._collect(self.topics, self.last_seq)
            if not events:
                self.broker._lock.wait(timeout)
                events = self.broker._collect(self.topics, self.last_seq)
            if events:
                self.last_seq = max(ev.seq for ev in events)
            return events

    def stream(self, poll_timeout: float = 1.0) -> Iterator[Event]:
        while not self.closed:
            for ev in self.next_events(timeout=poll_timeout):
                yield ev

    def close(self) -> None:
        self.closed = True
