"""Structured JSONL event log for fleet lifecycle events.

Replaces ad-hoc ``print`` statements with a single, thread-safe emitter.
Every event is one JSON object per line::

    {"event": "exclusion", "ts": 1723105000.123, "pid": 4242, "replica": "r2", ...}

Canonical event kinds emitted by the serving stack:

==================  ======================================================
``ready``           replica child process finished binding (rpc handshake)
``gen_swap``        a server adopted a new ModelGeneration
``reshard``         frontend completed a resize/exclusion reshard
``exclusion``       a dead replica was excluded from the ring
``replica_dead``    heartbeat/EOF death verdict for a remote replica
``refit``           OnlineRefitter published a new generation
``refit_failed``    a refit cycle raised
``scenario_start``  ScenarioRunner began replaying a schedule
``scenario_fault``  a scheduled fault event fired (publish/kill/resize)
``scenario_end``    replay finished (ground-truth counter summary)
==================  ======================================================

Events always land in an in-memory ring buffer (``tail()``); optionally
they are appended to a JSONL file (``configure(path=...)``) or written
to a stream. File writes happen line-at-a-time in append mode, so
multiple processes sharing one path interleave whole lines.

A module-level default log backs the convenience functions
:func:`emit` / :func:`configure` / :func:`tail`; components call
``events.emit(...)`` without threading a logger through every
constructor. **Do not** point a replica child's event stream at its
stdout pipe beyond the ready handshake: the parent stops draining stdout
after the ready line, and a filled pipe would wedge the child.

A copy of ``repro.obs.events`` (the port imports nothing of the
reference): event names and fields are the reference's.
"""
from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from typing import Dict, List, Optional

__all__ = ["EventLog", "emit", "configure", "tail", "clear"]


class EventLog:
    def __init__(self, path: Optional[str] = None, stream=None,
                 maxlen: int = 2048) -> None:
        self._lock = threading.Lock()
        self._buf: deque = deque(maxlen=int(maxlen))
        self._stream = stream
        self._path: Optional[str] = None
        self._fh = None
        if path:
            self.configure(path=path)

    def configure(self, path: Optional[str] = None, stream=None) -> None:
        """Point the log at a JSONL file and/or a stream. ``path=None``
        detaches the file; the ring buffer is always on."""
        with self._lock:
            if self._fh is not None:
                try:
                    self._fh.close()
                except Exception:
                    pass
                self._fh = None
            self._path = path
            if path:
                self._fh = open(path, "a", encoding="utf-8")
            if stream is not None:
                self._stream = stream

    @property
    def path(self) -> Optional[str]:
        return self._path

    def emit(self, event: str, **fields) -> Dict:
        rec = {"event": str(event), "ts": time.time(), "pid": os.getpid()}
        rec.update(fields)
        line = json.dumps(rec, separators=(",", ":"), default=str)
        with self._lock:
            self._buf.append(rec)
            if self._fh is not None:
                try:
                    self._fh.write(line + "\n")
                    self._fh.flush()
                except Exception:
                    pass
            if self._stream is not None:
                try:
                    self._stream.write(line + "\n")
                    self._stream.flush()
                except Exception:
                    pass
        return rec

    def tail(self, n: Optional[int] = None) -> List[Dict]:
        with self._lock:
            recs = list(self._buf)
        return recs if n is None else recs[-n:]

    def clear(self) -> None:
        with self._lock:
            self._buf.clear()

    def close(self) -> None:
        with self._lock:
            if self._fh is not None:
                try:
                    self._fh.close()
                except Exception:
                    pass
                self._fh = None
            self._stream = None


DEFAULT = EventLog()


def emit(event: str, **fields) -> Dict:
    return DEFAULT.emit(event, **fields)


def configure(path: Optional[str] = None, stream=None) -> None:
    DEFAULT.configure(path=path, stream=stream)


def tail(n: Optional[int] = None) -> List[Dict]:
    return DEFAULT.tail(n)


def clear() -> None:
    DEFAULT.clear()
