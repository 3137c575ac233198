"""JSONL event-log subscriber (port of ``daft_tpu/subscribers/event_log.py``;
reference: daft/subscribers/event_log.py).

Appends one JSON line per engine event; workers on other hosts can stream
events back to the driver by pointing at a shared path (the reference's
remote event-log sink, daft/runners/flotilla.py:171-176).

Bounded for always-on serving: an event subscriber that grows
state per event would OOM a process answering millions of queries, so

* the in-memory history is a ring (``maxlen=max_events``; ``recent()`` is
  the introspection surface), and
* the file rotates at ``max_bytes`` to ``<path>.1`` (previous rotation
  replaced — on-disk footprint bounded at ~2x the cap) via the shared
  rotating appender (utils/jsonl_sink.py).
"""

from __future__ import annotations

import dataclasses
import json
import threading
import time
from collections import deque
from typing import List, Optional

from daft_tpu_torch.subscribers.events import Event, Subscriber
from daft_tpu_torch.utils.jsonl_sink import DEFAULT_MAX_BYTES, RotatingJsonlSink

#: Default ring capacity for the in-memory recent-event history.
DEFAULT_MAX_EVENTS = 4096


class EventLogSubscriber(Subscriber):
    def __init__(self, path: str, max_bytes: int = DEFAULT_MAX_BYTES,
                 max_events: int = DEFAULT_MAX_EVENTS):
        self.path = path
        self._sink = RotatingJsonlSink(path, max_bytes=max_bytes)
        self._lock = threading.Lock()
        self._closed = False
        # Bounded retained history: an always-on serving process must not
        # grow event state without bound (the file is the durable record;
        # this ring serves "what just happened" introspection).
        self._recent: deque = deque(maxlen=max(int(max_events), 16))

    def on_event(self, event: Event) -> None:
        record = {"ts": time.time(), "event": type(event).__name__}
        record.update(dataclasses.asdict(event))
        line = json.dumps(record, default=str)
        with self._lock:
            if self._closed:
                return
            self._recent.append(record)
            self._sink.write_line(line)

    def recent(self, n: Optional[int] = None,
               event: Optional[str] = None) -> List[dict]:
        """Newest-first slice of the bounded in-memory history."""
        with self._lock:
            out = list(self._recent)
        out.reverse()
        if event:
            out = [r for r in out if r["event"] == event]
        return out[:n] if n else out

    def close(self) -> None:
        with self._lock:
            self._closed = True
            self._sink.close()
