"""RPC transport: the in-process fleet, process-separated.

``ClusterFrontend`` (``repro_torch.serve.cluster``) was built transport-
agnostic: it touches replicas only through the gateway interface
(``submit``/``observe``/``publish_generation``/``stats``/``stop``/
``service``). This module supplies the first real transport so the
fleet matches the paper's datacenter setting — predictors deployed
across hosts that crash, stall, and answer over a wire:

  * **frame protocol** — length-prefixed JSON over TCP: a 4-byte
    big-endian payload length followed by one UTF-8 JSON object.
    Requests carry ``{"id", "op", ...params}``; responses echo the id
    with ``{"ok": true, "result"}`` or ``{"ok": false, "error",
    "kind"}``. Replies are matched by id, so they may arrive out of
    order — a slow micro-batch never head-of-line-blocks a ping.
  * **``ReplicaServer``** — an asyncio TCP server wrapping one
    ``GatewayReplica`` in its own process (``python -m
    repro_torch.serve.rpc``). Blocking gateway calls run on an executor and
    submit replies are sent from the worker's Future callback, so the
    event loop keeps answering heartbeats while a batch is in flight.
  * **``RemoteReplica``** — the client stub implementing the replica
    interface over a blocking socket + background reader thread
    (request-id multiplexed Futures) + heartbeat thread. Every call is
    timeout-bounded. Missed heartbeats (or a dropped connection — a
    ``kill -9`` closes the socket) mark the replica ``dead``, fail all
    in-flight Futures with ``ReplicaUnavailable``, and fire ``on_dead``
    — which the frontend answers by resharding the member out
    (``ClusterFrontend.exclude_replica``) and hedging/retrying the
    affected queries to the next ring owner.

**Shared-disk assumption.** ``RemoteReplica`` holds *local*
``TraceStore``/``FeedbackStore`` handles over the same directories its
server process writes through. That one assumption makes the PR 5
reshard machinery work unchanged for remote members: slice migration
(``JsonFileStore.split``) and the crash-restart rebuild read the dead
replica's authoritative on-disk state directly — warm keys move to the
new owners with zero re-traces and no new transport code. Deployments
without a shared filesystem would substitute a store proxy here.

``synthetic_trace`` is the deterministic, dependency-free tracer the
multi-process tests and the chaos bench point every replica at (via
``--tracer repro_torch.serve.rpc:synthetic_trace``): real train-step tracing in N
spawned processes would dwarf the transport behavior under test, and
determinism is what lets a hedged duplicate or a rebuilt slice converge
byte-for-byte with the in-process fleet.

A copy of ``repro.serve.rpc`` (the port imports nothing of the reference):
the frame protocol, every op and every ``stats()`` / ``server_info()`` key
are the reference's. The child is ``python -m repro_torch.serve.rpc``, its
default tracer the port's ``trace_query``, which traces on fake tensors: a
replica never initialises CUDA. One op is the port's own: ``process``
(``RemoteReplica.process_info``) reports the child's pid, whether CUDA was
initialised there, and which of torch, jax and repro it has imported.
``synthetic_trace`` stamps its records ``PLATFORM_TORCH_CUDA``, the tag the
port's trace store serves.
"""

from __future__ import annotations

import argparse
import asyncio
import dataclasses
import importlib
import itertools
import json
import os
import select
import socket
import subprocess
import sys
import threading
import time
from concurrent.futures import Future
from concurrent.futures import TimeoutError as FutureTimeout
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.features import PLATFORM_TORCH_CUDA, ProfileRecord
from repro_torch.core.predictor import DNNAbacus
from repro_torch.obs import events
from repro_torch.serve.cluster import (GatewayReplica, ReplicaNotRunning,
                                       ReplicaUnavailable)
from repro_torch.serve.feedback_store import make_feedback_store
from repro_torch.serve.prediction_service import Query
from repro_torch.serve.refit import ModelGeneration
from repro_torch.serve.server import (DeadlineExceeded, QuotaExceeded,
                                      ServerStats)
from repro_torch.serve.trace_store import TraceStore, make_trace_store

MAX_FRAME = 64 << 20  # one serialized DNNAbacus generation fits with room


class RPCError(RuntimeError):
    """The remote gateway raised while serving the call (application
    error, e.g. an untraceable config). NOT retryable — the same query
    fails the same way on any replica."""


# -- frame protocol ----------------------------------------------------------

def pack_frame(obj) -> bytes:
    """One wire frame: 4-byte big-endian length + UTF-8 JSON payload."""
    data = json.dumps(obj, separators=(",", ":")).encode()
    if len(data) > MAX_FRAME:
        raise ValueError(f"frame of {len(data)} bytes exceeds MAX_FRAME")
    return len(data).to_bytes(4, "big") + data


def _recv_exact(sock: socket.socket, n: int) -> Optional[bytes]:
    """Exactly ``n`` bytes from a blocking socket, or None on EOF."""
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            return None
        buf += chunk
    return buf


def read_frame_sock(sock: socket.socket) -> Optional[Dict]:
    """Read one frame from a blocking socket; None on clean EOF."""
    header = _recv_exact(sock, 4)
    if header is None:
        return None
    n = int.from_bytes(header, "big")
    if n > MAX_FRAME:
        raise ValueError(f"incoming frame of {n} bytes exceeds MAX_FRAME")
    data = _recv_exact(sock, n)
    if data is None:
        return None
    return json.loads(data.decode())


async def read_frame_async(reader: asyncio.StreamReader) -> Optional[Dict]:
    """Read one frame from an asyncio stream; None on clean EOF."""
    try:
        header = await reader.readexactly(4)
    except (asyncio.IncompleteReadError, ConnectionError):
        return None
    n = int.from_bytes(header, "big")
    if n > MAX_FRAME:
        raise ValueError(f"incoming frame of {n} bytes exceeds MAX_FRAME")
    try:
        data = await reader.readexactly(n)
    except (asyncio.IncompleteReadError, ConnectionError):
        return None
    return json.loads(data.decode())


# -- config codec ------------------------------------------------------------
#
# Configs cross the wire by value. Fingerprints distinguish tuples from
# lists (see prediction_service._canonical), so the codec must round-trip
# that distinction — tuples are tagged, never silently listified.

def _encode_value(v):
    if v is None or isinstance(v, (bool, int, float, str)):
        return v
    if isinstance(v, tuple):
        return {"__tuple__": [_encode_value(x) for x in v]}
    if isinstance(v, list):
        return [_encode_value(x) for x in v]
    if isinstance(v, dict):
        if not all(isinstance(k, str) for k in v):
            raise TypeError("config dict fields need str keys on the wire")
        return {"__dict__": {k: _encode_value(x) for k, x in v.items()}}
    raise TypeError(
        f"config field of type {type(v).__name__} is not wire-serializable")


def _decode_value(v):
    if isinstance(v, list):
        return [_decode_value(x) for x in v]
    if isinstance(v, dict):
        if set(v) == {"__tuple__"}:
            return tuple(_decode_value(x) for x in v["__tuple__"])
        if set(v) == {"__dict__"}:
            return {k: _decode_value(x) for k, x in v["__dict__"].items()}
        raise ValueError(f"unrecognized wire value: {sorted(v)}")
    return v


class WireConfig:
    """Attribute-duck reconstruction of a config that crossed the wire.

    ``config_fingerprint`` canonicalizes duck-typed configs over
    ``vars()``, so a ``WireConfig`` carrying the same attributes
    fingerprints identically to the original duck-typed config — and
    tracers read config *attributes*, never its class.
    """

    def __init__(self, attrs: Dict):
        self.__dict__.update(attrs)

    def __repr__(self) -> str:
        return f"WireConfig({self.__dict__!r})"


def encode_config(cfg) -> Dict:
    if dataclasses.is_dataclass(cfg) and not isinstance(cfg, type):
        return {"dataclass":
                f"{type(cfg).__module__}:{type(cfg).__qualname__}",
                "fields": {f.name: _encode_value(getattr(cfg, f.name))
                           for f in dataclasses.fields(cfg)}}
    return {"attrs": {k: _encode_value(v) for k, v in vars(cfg).items()}}


def decode_config(d: Dict):
    if "dataclass" in d:
        fields = {k: _decode_value(v) for k, v in d["fields"].items()}
        mod, _, qual = d["dataclass"].partition(":")
        try:
            cls = importlib.import_module(mod)
            for part in qual.split("."):
                cls = getattr(cls, part)
            return cls(**fields)
        except Exception:
            # class not importable here: the attribute-duck stands in
            # (fingerprint parity matters only when fp isn't forwarded)
            return WireConfig(fields)
    return WireConfig({k: _decode_value(v) for k, v in d["attrs"].items()})


# -- deterministic tracer for spawned replicas -------------------------------

def synthetic_trace(cfg, batch: int, seq: int) -> ProfileRecord:
    """Deterministic stand-in tracer (no tracing, no model build).

    Derives a stable ``ProfileRecord`` purely from the config's
    attributes and ``(batch, seq)`` — any two processes given equal
    inputs produce byte-identical records, which is what lets an RPC
    fleet's estimates match an in-process fleet's exactly and lets a
    hedge-window duplicate trace converge with a migrated slice.
    """
    name = str(getattr(cfg, "name", "anon"))
    # never builtin hash(): records must be process/seed-deterministic
    rng = np.random.default_rng(sum(name.encode()) * 7 + int(batch))
    dots = float(rng.integers(4, 60))
    edges = {("dot", "add"): dots, ("add", "tanh"): dots}
    return ProfileRecord(
        model_name=name, family=str(getattr(cfg, "family", "dense")),
        batch_size=int(batch), input_size=int(seq),
        channels=int(getattr(cfg, "d_model", 64)), learning_rate=1e-3,
        epoch=1, optimizer="adamw",
        layers=int(getattr(cfg, "num_layers", 4)),
        flops=int(batch) * int(seq) * dots * 1e6, params=int(dots * 1e5),
        nsm_edges=edges, platform=PLATFORM_TORCH_CUDA)


def resolve_tracer(spec: str):
    """``"module:attr"`` -> tracer callable (spawned replicas' CLI)."""
    mod, _, attr = spec.partition(":")
    return getattr(importlib.import_module(mod), attr or "trace_query")


# -- server side -------------------------------------------------------------

def process_info() -> Dict:
    """This process's pid, whether it initialised CUDA, and which of
    torch, jax and repro it imported. Never initialises CUDA itself."""
    torch = sys.modules.get("torch")
    return {"pid": os.getpid(),
            "cuda_initialized": bool(torch is not None
                                     and torch.cuda.is_initialized()),
            "modules": {m: m in sys.modules for m in ("torch", "jax", "repro")}}


_GEN_FIELDS = {f.name for f in dataclasses.fields(ModelGeneration)} \
    - {"number", "abacus"}


class ReplicaServer:
    """Asyncio TCP front for one ``GatewayReplica`` in this process.

    Each connection is served concurrently: every incoming frame
    dispatches as its own task, blocking gateway calls (``observe``,
    ``stop``, ``stats``) run on the default executor, and a ``submit``
    reply is sent from the gateway Future's callback — the event loop
    itself never blocks, so heartbeats stay honest while a micro-batch
    (or a drain) is in flight.
    """

    def __init__(self, replica: GatewayReplica, host: str = "127.0.0.1",
                 port: int = 0):
        self.replica = replica
        self.host = host
        self.port = int(port)
        self._stopping: Optional[asyncio.Event] = None

    def run_forever(self, ready_cb=None) -> None:
        """Serve until a ``shutdown`` op arrives; blocks the caller."""
        asyncio.run(self._serve(ready_cb))

    async def _serve(self, ready_cb=None) -> None:
        self._stopping = asyncio.Event()
        server = await asyncio.start_server(self._handle, self.host,
                                            self.port)
        self.port = server.sockets[0].getsockname()[1]
        if ready_cb is not None:
            ready_cb(self.port)
        async with server:
            await self._stopping.wait()

    async def _handle(self, reader: asyncio.StreamReader,
                      writer: asyncio.StreamWriter) -> None:
        send_lock = asyncio.Lock()

        async def send(payload: Dict) -> None:
            async with send_lock:
                writer.write(pack_frame(payload))
                await writer.drain()

        try:
            while True:
                msg = await read_frame_async(reader)
                if msg is None:
                    break
                asyncio.ensure_future(self._dispatch(msg, send))
        except (ConnectionError, ValueError):
            pass
        finally:
            try:
                writer.close()
            except Exception:
                pass

    async def _dispatch(self, msg: Dict, send) -> None:
        mid, op = msg.get("id"), msg.get("op")
        loop = asyncio.get_running_loop()
        replica, svc = self.replica, self.replica.service
        try:
            if op == "submit":
                # "tc" carries the frontend's trace context across the
                # process boundary; the gateway's tick stamps spans and
                # ships them back inside the estimate ("_trace").
                # Deadlines cross as a *remaining budget* ("deadline_in",
                # seconds) because monotonic clocks don't compare across
                # processes; the absolute deadline is rebuilt here.
                kw = {}
                if msg.get("tenant"):
                    kw["tenant"] = str(msg["tenant"])
                if msg.get("deadline_in") is not None:
                    kw["deadline"] = (time.monotonic()
                                      + float(msg["deadline_in"]))
                fut = replica.submit(decode_config(msg["cfg"]),
                                     msg["batch"], msg["seq"],
                                     fp=msg.get("fp"), tc=msg.get("tc"),
                                     **kw)

                def relay(f: Future, mid=mid) -> None:
                    # worker thread -> event loop: schedule the reply
                    try:
                        payload = {"id": mid, "ok": True,
                                   "result": f.result()}
                    except Exception as e:
                        if isinstance(e, DeadlineExceeded):
                            kind = "deadline"
                        elif isinstance(e, QuotaExceeded):
                            kind = "quota"
                        else:
                            kind = "query"
                        payload = {"id": mid, "ok": False,
                                   "error": f"{type(e).__name__}: {e}",
                                   "kind": kind}
                    asyncio.run_coroutine_threadsafe(send(payload), loop)

                fut.add_done_callback(relay)
                return  # reply is deferred to the worker's callback
            elif op == "ping":
                result = {"pid": os.getpid(), "running": replica.running,
                          "draining": replica.draining,
                          "generation": svc.generation,
                          "ticks": replica.stats.ticks}
            elif op == "state":
                result = {"running": replica.running,
                          "draining": replica.draining,
                          "generation": svc.generation}
            elif op == "observe":

                def _observe(m=msg):
                    replica.observe(
                        decode_config(m["cfg"]), m["batch"], m["seq"],
                        m["time_s"], m["mem_bytes"],
                        predicted_time_s=m.get("predicted_time_s"),
                        predicted_mem_bytes=m.get("predicted_mem_bytes"),
                        generation=m.get("generation"),
                        job_id=m.get("job_id", ""), fp=m.get("fp"),
                        tenant=m.get("tenant", ""))

                await loop.run_in_executor(None, _observe)
                result = True
            elif op == "publish_generation":
                gen = self._decode_generation(msg)
                result = bool(await loop.run_in_executor(
                    None, replica.publish_generation, gen))
            elif op == "adopt":
                abacus = DNNAbacus.from_dict(msg["abacus"])
                result = bool(svc.adopt(abacus, int(msg["generation"])))
            elif op == "snapshot":
                abacus, generation = svc.snapshot()
                result = {"abacus": abacus.to_dict(),
                          "generation": generation}
            elif op == "stats":
                result = await loop.run_in_executor(None, replica.stats)
            elif op == "counters":
                result = replica.stats.as_dict()
            elif op == "overload":
                result = replica.overload_counters()
            elif op == "metrics":
                result = await loop.run_in_executor(
                    None, replica.metrics_snapshot)
            elif op == "server_info":
                result = await loop.run_in_executor(None,
                                                    replica.server_info)
            elif op == "process":
                result = process_info()
            elif op == "start":
                replica.start()
                result = True
            elif op == "stop":
                await loop.run_in_executor(
                    None, lambda: replica.stop(timeout=msg.get("timeout")))
                result = {"draining": replica.draining}
            elif op == "shutdown":
                await loop.run_in_executor(
                    None, lambda: replica.stop(timeout=msg.get("timeout")))
                await send({"id": mid, "ok": True, "result": True})
                self._stopping.set()
                return
            else:
                raise ValueError(f"unknown op {op!r}")
            await send({"id": mid, "ok": True, "result": result})
        except Exception as e:
            # overload raises are typed BEFORE the not_running string
            # check: both subclass RuntimeError, and a quota rejection
            # must never be mistaken for a drained replica (which the
            # frontend would answer by re-routing the query).
            if isinstance(e, QuotaExceeded):
                kind = "quota"
            elif isinstance(e, DeadlineExceeded):
                kind = "deadline"
            elif (op in ("submit",) and isinstance(e, RuntimeError)
                  and "not running" in str(e)):
                kind = "not_running"
            else:
                kind = "error"
            try:
                await send({"id": mid, "ok": False,
                            "error": f"{type(e).__name__}: {e}",
                            "kind": kind})
            except Exception:
                pass  # client went away mid-reply

    @staticmethod
    def _decode_generation(msg: Dict) -> ModelGeneration:
        extra = {k: v for k, v in (msg.get("summary") or {}).items()
                 if k in _GEN_FIELDS}
        return ModelGeneration(number=int(msg["number"]),
                               abacus=DNNAbacus.from_dict(msg["abacus"]),
                               **extra)


# -- client side -------------------------------------------------------------

def _resolve(fut: Future, result) -> None:
    try:
        fut.set_result(result)
    except Exception:
        pass  # cancelled / already failed by a timeout sweep


def _fail(fut: Future, err: Exception) -> None:
    try:
        fut.set_exception(err)
    except Exception:
        pass


def _normalize_calibration(cal: Optional[Dict]) -> Dict:
    """Undo JSON's stringification of ``by_generation`` int/None keys."""
    cal = dict(cal or {})
    by_gen = cal.get("by_generation")
    if isinstance(by_gen, dict):
        fixed = {}
        for k, v in by_gen.items():
            if k in ("null", "None"):
                fixed[None] = v
            else:
                try:
                    fixed[int(k)] = v
                except (TypeError, ValueError):
                    fixed[k] = v
        cal["by_generation"] = fixed
    return cal


class _RemoteStats:
    """Remote ``ServerStats`` mirror: attribute-addressable AND callable.

    ``replica.stats.ticks`` fetches the live counters over the wire
    (cached last-known values once the replica is dead — the exclusion
    reshard still sums ticks over members that can no longer answer);
    ``replica.stats()`` returns the full stats dict, calibration keys
    re-normalized after their JSON round trip.
    """

    _COUNTERS = tuple(ServerStats.COUNTERS)

    def __init__(self, replica: "RemoteReplica"):
        self._replica = replica

    def __call__(self) -> Dict:
        return self._replica._full_stats()

    def as_dict(self) -> Dict[str, int]:
        return dict(self._replica._counters())

    @property
    def mean_batch(self) -> float:
        c = self._replica._counters()
        ticks = c.get("ticks", 0)
        return (c.get("completed", 0) + c.get("failed", 0)) / ticks \
            if ticks else 0.0

    def __getattr__(self, item):
        if item in _RemoteStats._COUNTERS:
            return self._replica._counters().get(item, 0)
        raise AttributeError(item)


class _RemoteService:
    """The slice of ``PredictionService`` the frontend touches, remoted.

    ``store`` is a LOCAL ``TraceStore`` handle over the replica
    process's trace directory (the shared-disk assumption): slice
    migration and crash rebuild read/move the authoritative files
    directly. ``generation`` falls back to the last heartbeat-cached
    value once the replica is dead.
    """

    def __init__(self, replica: "RemoteReplica",
                 store: Optional[TraceStore]):
        self._replica = replica
        self.store = store
        self._generation = 0

    @property
    def generation(self) -> int:
        try:
            st = self._replica._call("state")
            self._generation = int(st.get("generation", self._generation))
        except ReplicaUnavailable:
            pass
        return self._generation

    @property
    def abacus(self) -> DNNAbacus:
        return self.snapshot()[0]

    def snapshot(self) -> Tuple[DNNAbacus, int]:
        d = self._replica._call("snapshot")
        self._generation = int(d["generation"])
        return DNNAbacus.from_dict(d["abacus"]), self._generation

    def adopt(self, abacus, generation: int) -> bool:
        return bool(self._replica._call(
            "adopt", {"abacus": abacus.to_dict(),
                      "generation": int(generation)}))

    def cached_record(self, key):
        """The remote memory cache is unreachable; the store handle
        (same files the remote traced into) answers instead."""
        return None


class RemoteReplica:
    """Client stub for one ``ReplicaServer``: the replica interface,
    over the wire.

    A background reader thread multiplexes replies onto per-request
    Futures; a heartbeat thread pings every ``heartbeat_interval``
    seconds and sweeps timed-out calls. ``heartbeat_misses`` consecutive
    failed pings — or the connection dropping (a ``kill -9``'d server
    closes its socket) — mark the replica ``dead``: every in-flight
    Future fails with ``ReplicaUnavailable`` (the frontend's guard
    re-routes them) and ``on_dead`` fires exactly once.
    """

    supports_hedge = True  # frontend: guard futures, hedge, retry

    def __init__(self, name: str, host: str, port: int, *,
                 trace_root: Optional[str] = None,
                 feedback_root: Optional[str] = None,
                 proc: Optional[subprocess.Popen] = None,
                 call_timeout: float = 10.0, submit_timeout: float = 120.0,
                 heartbeat_interval: float = 0.5, heartbeat_misses: int = 3,
                 connect_timeout: float = 10.0, on_dead=None):
        self.name = str(name)
        self.host, self.port = host, int(port)
        self.proc = proc
        self.on_dead = on_dead
        self.dead = False
        self.dead_reason: Optional[str] = None
        self.call_timeout = float(call_timeout)
        self.submit_timeout = float(submit_timeout)
        self.heartbeat_interval = float(heartbeat_interval)
        self.heartbeat_misses = int(heartbeat_misses)
        # backend from REPRO_STORE_BACKEND (inherited by spawned server
        # children, so both sides of the wire read one physical layout)
        self.feedback = (make_feedback_store(feedback_root)
                         if feedback_root else None)
        self.service = _RemoteService(
            self, make_trace_store(trace_root) if trace_root else None)
        self.stats = _RemoteStats(self)
        self._counters_cache: Dict[str, int] = {}
        self._overload_cache: Dict[str, int] = {}
        self._cache_at: Optional[float] = None  # monotonic age of the cache
        self._closing = False
        self._dead_fired = False
        self._wlock = threading.Lock()
        self._plock = threading.Lock()
        self._pending: Dict[int, Tuple[Future, float]] = {}
        self._ids = itertools.count(1)
        self._sock = socket.create_connection((host, self.port),
                                              timeout=connect_timeout)
        self._sock.settimeout(None)
        try:
            self._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        except OSError:
            pass
        self._reader = threading.Thread(
            target=self._read_loop, name=f"rpc-read-{self.name}",
            daemon=True)
        self._reader.start()
        self._beat = threading.Thread(
            target=self._heartbeat_loop, name=f"rpc-beat-{self.name}",
            daemon=True)
        self._beat.start()

    # -- wire plumbing ------------------------------------------------------
    def _request(self, op: str, params: Optional[Dict],
                 timeout: float) -> Future:
        if self.dead:
            raise ReplicaUnavailable(
                f"replica {self.name} is dead ({self.dead_reason})")
        fut: Future = Future()
        mid = next(self._ids)
        with self._plock:
            self._pending[mid] = (fut, time.monotonic() + timeout)
        frame = pack_frame({"id": mid, "op": op, **(params or {})})
        try:
            with self._wlock:
                self._sock.sendall(frame)
        except OSError as e:
            with self._plock:
                self._pending.pop(mid, None)
            self._mark_dead(f"send failed: {e}")
            raise ReplicaUnavailable(
                f"replica {self.name}: send failed: {e}") from e
        return fut

    def _call(self, op: str, params: Optional[Dict] = None,
              timeout: Optional[float] = None):
        timeout = self.call_timeout if timeout is None else float(timeout)
        fut = self._request(op, params, timeout)
        try:
            # the heartbeat sweep fails the Future at its deadline; the
            # margin here only covers a dead sweeper (closed stub)
            return fut.result(timeout + 2 * self.heartbeat_interval + 1.0)
        except FutureTimeout:
            raise ReplicaUnavailable(
                f"replica {self.name}: {op} timed out after {timeout}s")

    def _read_loop(self) -> None:
        try:
            while True:
                msg = read_frame_sock(self._sock)
                if msg is None:
                    break
                with self._plock:
                    entry = self._pending.pop(msg.get("id"), None)
                if entry is None:
                    continue  # reply raced a timeout sweep: dropped
                fut = entry[0]
                if msg.get("ok"):
                    _resolve(fut, msg.get("result"))
                elif msg.get("kind") == "not_running":
                    _fail(fut, ReplicaNotRunning(msg.get("error", "")))
                elif msg.get("kind") == "deadline":
                    _fail(fut, DeadlineExceeded(msg.get("error", "")))
                elif msg.get("kind") == "quota":
                    _fail(fut, QuotaExceeded(msg.get("error", "")))
                else:
                    _fail(fut, RPCError(msg.get("error", "")))
        except (OSError, ValueError):
            pass
        self._mark_dead("connection closed")

    def _heartbeat_loop(self) -> None:
        misses = 0
        while not self._closing and not self.dead:
            time.sleep(self.heartbeat_interval)
            if self._closing or self.dead:
                return
            self._sweep(time.monotonic())
            try:
                pong = self._call("ping",
                                  timeout=self.heartbeat_interval + 0.25)
                self.service._generation = int(
                    pong.get("generation", self.service._generation))
                misses = 0
            except Exception:
                misses += 1
                if misses >= self.heartbeat_misses:
                    self._mark_dead(f"{misses} heartbeats missed")
                    return

    def _sweep(self, now: float) -> None:
        """Fail calls whose deadline passed (bounded-call guarantee)."""
        expired: List[Future] = []
        with self._plock:
            for mid, (fut, deadline) in list(self._pending.items()):
                if now > deadline:
                    expired.append(fut)
                    del self._pending[mid]
        for fut in expired:
            _fail(fut, ReplicaUnavailable(
                f"replica {self.name}: call deadline passed"))

    def _mark_dead(self, reason: str) -> None:
        with self._plock:
            if self._dead_fired:
                return
            self._dead_fired = True
            self.dead = True
            self.dead_reason = reason
            pending = list(self._pending.values())
            self._pending = {}
            fire = not self._closing
        for fut, _ in pending:
            _fail(fut, ReplicaUnavailable(
                f"replica {self.name} died: {reason}"))
        try:
            self._sock.close()
        except OSError:
            pass
        cb = self.on_dead
        if fire:
            events.emit("replica_dead", replica=self.name, reason=reason)
        if fire and cb is not None:
            try:
                cb(self)
            except Exception:
                pass  # a broken callback must not kill the transport

    # -- replica interface ---------------------------------------------------
    def submit(self, cfg, batch: int, seq: int,
               fp: Optional[str] = None, tc=None, *, tenant: str = "",
               deadline: Optional[float] = None) -> Future:
        params = {"cfg": encode_config(cfg), "batch": int(batch),
                  "seq": int(seq), "fp": fp}
        if tc is not None:  # trace context crosses inside the frame header
            params["tc"] = tc
        if tenant:
            params["tenant"] = str(tenant)
        if deadline is not None:
            # monotonic clocks don't compare across processes: ship the
            # remaining budget, the server re-anchors it on its clock.
            params["deadline_in"] = max(0.0,
                                        float(deadline) - time.monotonic())
        return self._request("submit", params, self.submit_timeout)

    def submit_many(self, queries: Sequence) -> List[Future]:
        """Pipelined per-query frames: the server's gateway coalesces
        back-to-back arrivals into one micro-batch tick anyway."""
        futs = []
        for q in queries:
            q = q if isinstance(q, Query) else Query(*q)
            futs.append(self.submit(
                q.cfg, q.batch, q.seq, fp=q.fp, tc=q.tc,
                tenant=getattr(q, "tenant", ""),
                deadline=getattr(q, "deadline", None)))
        return futs

    def predict_one(self, cfg, batch: int, seq: int,
                    timeout: Optional[float] = None) -> Dict:
        return self.submit(cfg, batch, seq).result(timeout)

    def observe(self, cfg, batch: int, seq: int, time_s: float,
                mem_bytes: float, *,
                predicted_time_s: Optional[float] = None,
                predicted_mem_bytes: Optional[float] = None,
                generation: Optional[int] = None, job_id: str = "",
                fp: Optional[str] = None, tenant: str = "") -> None:
        params = {
            "cfg": encode_config(cfg), "batch": int(batch),
            "seq": int(seq), "time_s": float(time_s),
            "mem_bytes": float(mem_bytes),
            "predicted_time_s": predicted_time_s,
            "predicted_mem_bytes": predicted_mem_bytes,
            "generation": generation, "job_id": str(job_id), "fp": fp}
        if tenant:
            params["tenant"] = str(tenant)
        self._call("observe", params)

    def publish_generation(self, gen) -> bool:
        to_dict = getattr(gen.abacus, "to_dict", None)
        if to_dict is None:
            raise TypeError(
                f"generation {gen.number} carries a predictor without "
                "to_dict(); it cannot cross the wire")
        return bool(self._call("publish_generation",
                               {"number": int(gen.number),
                                "abacus": to_dict(),
                                "summary": gen.summary()}))

    # -- stats ---------------------------------------------------------------
    def _counters(self) -> Dict[str, int]:
        try:
            c = self._call("counters")
        except ReplicaUnavailable:
            return dict(self._counters_cache)
        self._counters_cache = dict(c)
        self._cache_at = time.monotonic()
        return c

    def overload_counters(self) -> Dict[str, int]:
        """Remote shed/expired/quota counters; last-known values once
        dead, so the exclusion reshard can still bank them."""
        try:
            c = self._call("overload")
        except ReplicaUnavailable:
            return dict(self._overload_cache)
        self._overload_cache = dict(c)
        return c

    def _full_stats(self) -> Dict:
        try:
            d = self._call("stats")
        except ReplicaUnavailable:
            # cached fallback, explicitly marked: a dead member's last
            # words must be distinguishable from live data, and
            # as_of_monotonic says how old they are.
            return {"replica": self.name, "dead": True, "stale": True,
                    "as_of_monotonic": self._cache_at,
                    **dict(self._counters_cache)}
        d["calibration"] = _normalize_calibration(d.get("calibration"))
        self._counters_cache = {k: d[k] for k in _RemoteStats._COUNTERS
                                if k in d}
        self._cache_at = time.monotonic()
        return d

    def server_info(self) -> Dict:
        try:
            info = self._call("server_info")
        except ReplicaUnavailable:
            return {"replica": self.name, "dead": True, "stale": True,
                    "as_of_monotonic": self._cache_at, "running": False,
                    "queued": 0, **dict(self._counters_cache)}
        self._counters_cache = {k: info[k] for k in _RemoteStats._COUNTERS
                                if k in info}
        self._cache_at = time.monotonic()
        return info

    def process_info(self) -> Dict:
        """The child's ``process_info()`` (``process`` op)."""
        return self._call("process")

    def metrics_snapshot(self) -> Dict:
        """The remote gateway's registry snapshot (``metrics`` op).
        Raises ``ReplicaUnavailable`` when the replica is dead — the
        fleet merge skips it and counts it unreachable."""
        return self._call("metrics")

    # -- lifecycle -----------------------------------------------------------
    @property
    def running(self) -> bool:
        if self.dead:
            return False
        try:
            return bool(self._call("state")["running"])
        except ReplicaUnavailable:
            return False

    @property
    def draining(self) -> bool:
        if self.dead:
            return False  # a dead process has no worker left to drain
        try:
            return bool(self._call("state")["draining"])
        except ReplicaUnavailable:
            return False

    def start(self) -> "RemoteReplica":
        self._call("start")
        return self

    def stop(self, timeout: Optional[float] = 10.0) -> None:
        if self.dead:
            return
        try:
            self._call("stop", {"timeout": timeout},
                       timeout=(timeout or 10.0) + self.call_timeout)
        except ReplicaUnavailable:
            pass  # died mid-drain: exclusion handles it

    def close(self) -> None:
        """Tear down the stub (threads exit; ``on_dead`` will not fire)."""
        self._closing = True
        try:
            self._sock.close()
        except OSError:
            pass
        with self._plock:
            pending = list(self._pending.values())
            self._pending = {}
        for fut, _ in pending:
            _fail(fut, ReplicaUnavailable(f"replica {self.name} closed"))

    def shutdown(self, timeout: float = 10.0) -> None:
        """Graceful teardown of stub AND server process."""
        if not self.dead:
            try:
                self._call("shutdown", {"timeout": timeout},
                           timeout=timeout + self.call_timeout)
            except Exception:
                pass
        self.close()
        if self.proc is not None:
            try:
                self.proc.wait(timeout)
            except Exception:
                self.proc.kill()
                try:
                    self.proc.wait(5)
                except Exception:
                    pass

    def kill(self) -> None:
        """``kill -9`` the spawned server process (chaos testing)."""
        if self.proc is not None:
            self.proc.kill()


# -- process management ------------------------------------------------------

def _src_dir() -> str:
    """The PYTHONPATH entry that makes ``repro_torch`` importable in a child."""
    import repro_torch
    return os.path.dirname(list(repro_torch.__path__)[0])


def spawn_replica(name: str, predictor_path: str, *,
                  trace_root: Optional[str] = None,
                  feedback_root: Optional[str] = None,
                  tracer: Optional[str] = None, host: str = "127.0.0.1",
                  startup_timeout: float = 60.0,
                  python: Optional[str] = None,
                  event_log: Optional[str] = None,
                  max_queue: Optional[int] = None,
                  shed_watermark: Optional[int] = None,
                  **remote_kw) -> RemoteReplica:
    """Spawn ``python -m repro_torch.serve.rpc`` and connect a stub to it.

    The child prints a single ``{"event": "ready", "port": ...}`` JSON
    line once it is listening (port 0 means kernel-assigned); stderr is
    inherited so a crashing child is diagnosable from the parent's
    output. ``tracer`` is a ``module:attr`` spec (tests/benches pass
    ``repro_torch.serve.rpc:synthetic_trace``).
    """
    cmd = [python or sys.executable, "-m", "repro_torch.serve.rpc",
           "--name", str(name), "--predictor", str(predictor_path),
           "--host", host, "--port", "0"]
    if trace_root:
        cmd += ["--trace-store", str(trace_root)]
    if feedback_root:
        cmd += ["--feedback-store", str(feedback_root)]
    if tracer:
        cmd += ["--tracer", tracer]
    if event_log:
        cmd += ["--event-log", str(event_log)]
    if max_queue is not None:
        cmd += ["--max-queue", str(max_queue)]
    if shed_watermark is not None:
        cmd += ["--shed-watermark", str(shed_watermark)]
    env = dict(os.environ)
    env["PYTHONPATH"] = _src_dir() + (
        os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, env=env, text=True)
    deadline = time.monotonic() + startup_timeout
    ready = None
    try:
        while time.monotonic() < deadline:
            if proc.poll() is not None:
                raise RuntimeError(
                    f"replica {name} exited with code {proc.returncode} "
                    "before becoming ready")
            rl, _, _ = select.select([proc.stdout], [], [], 0.2)
            if not rl:
                continue
            line = proc.stdout.readline()
            if not line:
                continue
            try:
                msg = json.loads(line)
            except ValueError:
                continue  # stray stdout noise
            if msg.get("event") == "ready":
                ready = msg
                break
        if ready is None:
            raise TimeoutError(
                f"replica {name} not ready within {startup_timeout}s")
        return RemoteReplica(name, host, int(ready["port"]),
                             trace_root=trace_root,
                             feedback_root=feedback_root, proc=proc,
                             **remote_kw)
    except BaseException:
        proc.kill()
        raise


def spawn_fleet(n_or_names, predictor_path: str, root: str, *,
                tracer: Optional[str] = None,
                event_log: Optional[str] = None,
                **kw) -> List[RemoteReplica]:
    """Spawn a homogeneous fleet with per-replica store slices under
    ``root`` — the layout ``ClusterFrontend(abacus, n, trace_root=...,
    feedback_root=...)`` uses, so RPC and in-process fleets over the
    same ``root`` shard identically."""
    names = ([f"r{i}" for i in range(n_or_names)]
             if isinstance(n_or_names, int)
             else [str(n) for n in n_or_names])
    replicas: List[RemoteReplica] = []
    try:
        for name in names:
            replicas.append(spawn_replica(
                name, predictor_path,
                trace_root=os.path.join(root, "traces", name),
                feedback_root=os.path.join(root, "feedback", name),
                tracer=tracer, event_log=event_log, **kw))
    except BaseException:
        shutdown_fleet(replicas)
        raise
    return replicas


def shutdown_fleet(replicas: Sequence[RemoteReplica],
                   timeout: float = 10.0) -> None:
    for r in replicas:
        try:
            r.shutdown(timeout)
        except Exception:
            pass


# -- CLI ---------------------------------------------------------------------

def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.serve.rpc",
        description="Serve one GatewayReplica over the TCP frame protocol")
    ap.add_argument("--name", required=True)
    ap.add_argument("--predictor", required=True,
                    help="DNNAbacus.save path (without the .json suffix)")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=0,
                    help="0 = kernel-assigned (reported on the ready line)")
    ap.add_argument("--trace-store", default=None)
    ap.add_argument("--feedback-store", default=None)
    ap.add_argument("--tracer",
                    default="repro_torch.serve.prediction_service:trace_query",
                    help="module:attr of the tracer callable")
    ap.add_argument("--max-batch", type=int, default=256)
    ap.add_argument("--trace-workers", type=int, default=4)
    ap.add_argument("--max-queue", type=int, default=None,
                    help="bound the pending queue; per-tenant weighted-"
                         "fair shares of it gate admission")
    ap.add_argument("--shed-watermark", type=int, default=None,
                    help="queue depth past which submits are answered "
                         "from the roofline floor (degraded)")
    ap.add_argument("--event-log", default=None,
                    help="JSONL file for this replica's lifecycle events "
                         "(gen swaps etc.); safe to share across a fleet "
                         "(line-append writes)")
    args = ap.parse_args(argv)

    if args.event_log:
        events.configure(path=args.event_log)
    server_kw = {}
    if args.max_queue is not None:
        server_kw["max_queue"] = args.max_queue
    if args.shed_watermark is not None:
        server_kw["shed_watermark"] = args.shed_watermark
    replica = GatewayReplica(
        args.name, DNNAbacus.load(args.predictor),
        store=(make_trace_store(args.trace_store)
               if args.trace_store else None),
        feedback=(make_feedback_store(args.feedback_store)
                  if args.feedback_store else None),
        tracer=resolve_tracer(args.tracer), max_batch=args.max_batch,
        trace_workers=args.trace_workers, **server_kw)
    replica.start()
    server = ReplicaServer(replica, host=args.host, port=args.port)

    # the ready handshake is itself a structured event; it ALSO goes to
    # stdout (same wire shape as before: {"event": "ready", "port": ...})
    # because spawn_replica blocks on that line. Only this one event may
    # use stdout — the parent stops draining the pipe afterwards.
    handshake = events.EventLog(stream=sys.stdout)

    def ready(port: int) -> None:
        events.emit("replica_started", replica=args.name, port=port)
        handshake.emit("ready", name=args.name, port=port)

    try:
        server.run_forever(ready_cb=ready)
    finally:
        replica.stop(timeout=10.0)
        events.emit("replica_stopped", replica=args.name)
    return 0


if __name__ == "__main__":
    sys.exit(main())
