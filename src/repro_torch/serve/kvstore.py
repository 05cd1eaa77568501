"""Durable key->value store engines behind one commutative merge contract.

``TraceStore`` (PR 2) and ``FeedbackStore`` (PR 3) grew the same
persistence discipline independently: a schema version stamped into
every record, corrupt/foreign data skipped (counted, never fatal), and
atomic writes so concurrent readers never observe a torn record. This
module owns that discipline in one place, split into two layers:

**The contract** (``KVStoreBase``) — everything the serving fabric is
built on, independent of physical layout:

  * **``merge`` / ``_merge_one``** — order-independent union: the
    subclass's ``_merge_raw`` must be commutative and idempotent, which
    makes any sequence of cross-host merges converge to one fixed
    point — the primitive the multi-host fabric (``repro_torch.serve.cluster``)
    is built on. ``merge(other, keys=...)`` restricts the union to a
    key slice.
  * **``extract`` / ``split``** — key-predicate slice handoff: a shard
    can read (``extract``) or *move* (``split``) exactly one set of
    keys into another store, through the same ``_merge_raw`` contract,
    so live resharding inherits merge's convergence and corrupt-skip
    guarantees instead of reinventing a copy path.
  * **value hooks** — ``VALUE_FIELD`` names the payload slot,
    ``_check_raw`` validates a loaded value, ``_servable`` optionally
    deep-validates at compact time, ``_merge_raw`` unions two values,
    ``_note_corrupt``/``_on_merge``/``_on_split`` observe events.

**The engines** — two interchangeable physical layouts:

  * ``JsonFileStore`` — one JSON file per key, same-directory temp +
    ``os.replace`` writes. Simple, debuggable, and fine at 10^3 keys;
    at 10^6 keys the per-key open/stat/rename traffic dominates every
    cold start, merge, and reshard.
  * ``SegmentLogStore`` — an append-only segment log: records append
    to an active segment that seals at a size threshold, an in-memory
    ``key -> (segment, offset)`` index rebuilds on open by scanning
    segments newest-first, and compaction rewrites live records into
    fresh (higher-numbered) segments before atomically retiring the old
    ones. Corrupt-skip semantics move from per-file to per-record: each
    record carries a CRC32; a torn tail record (a crash mid-append) is
    truncated, never fatal, and a corrupt mid-segment record skips only
    itself (the scanner resyncs on the next record magic). Because
    compaction's fresh segments outnumber the old ones, a crash at ANY
    point leaves a directory that reopens to the same live contents —
    the newest-first scan dedupes.

Both engines serve the same contract, proven by the differential + crash
harness in ``tests/test_store_engines.py``. ``store_backend`` /
``STORE_BACKENDS`` resolve a backend by name (``REPRO_STORE_BACKEND``
env var selects the fleet-wide default).

A copy of ``repro.serve.kvstore`` (the port imports nothing of the
reference): the on-disk layout, ``SCHEMA_VERSION`` and
``REPRO_STORE_BACKEND`` are the reference's, so either package opens the
other's directories. The segment engine differs in one respect: two
instances over one directory (a reader and another instance's ``compact``,
or a reader and another instance's append) cannot race. In the reference,
a rescan could list a segment that a concurrent compaction then retired,
and so build an index that lacked live records, or raise
``FileNotFoundError``; and it could truncate, as a torn tail, a record that
another instance was still writing. Here a rescan counts only once the
directory it listed is the one it ends on (``_open``), a read whose segment
vanished rescans until the key's record is found or a stable scan says it
is gone (``get_raw``), ``compact`` retires only segments its index was
built from, each read whole, and every writer holds an ``flock`` on the
segment it is writing, which a rescan must take before it truncates a torn
tail.
"""

from __future__ import annotations

import fcntl
import json
import os
import struct
import tempfile
import threading
import time
import zlib
from typing import (Callable, Dict, Iterable, Iterator, List, Optional,
                    Tuple)

StoreKey = Tuple[str, int, int]  # (config fingerprint, batch, seq)

# ONE schema generation for every store subclass. Bumping this
# invalidates (skips, then compacts away) every on-disk record of every
# store at once — traces and feedback can never drift onto different
# version ladders again.
SCHEMA_VERSION = 1


def atomic_write_json(root: str, path: str, payload: Dict) -> None:
    """Same-directory temp file + ``os.replace``: concurrent readers see
    the old file or the new one, never a torn record. Shared by every
    durable store in ``repro_torch.serve`` (traces, feedback) so the write
    discipline is fixed in exactly one place."""
    fd, tmp = tempfile.mkstemp(dir=root, suffix=".tmp")
    try:
        with os.fdopen(fd, "w") as f:
            json.dump(payload, f)
        os.replace(tmp, path)  # atomic on POSIX
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


class KVStoreBase:
    """The store contract: value semantics + merge/extract/split, with
    the physical layout delegated to engine primitives.

    Engines implement ``get_raw`` / ``put_raw`` / ``_delete_key`` /
    ``iter_raw`` / ``__len__`` / ``clear`` / ``compact`` /
    ``_purge_unloadable``; everything the serving fabric calls
    (``merge``, ``extract``, ``split``, ``keys``, ``raw_snapshot``)
    is defined here once, so the two engines cannot drift apart.
    """

    FILE_PREFIX = ""        # e.g. "fb_" keeps feedback files greppable
    VALUE_FIELD = "value"   # payload slot the subclass's value lives in
    schema_version = SCHEMA_VERSION  # shared: see module docstring

    def __init__(self, root: str):
        self.root = str(root)
        os.makedirs(self.root, exist_ok=True)
        # reentrant: read-modify-write paths hold it across loads that
        # may themselves take it to count a corrupt record
        self._lock = threading.RLock()

    # -- key mapping ---------------------------------------------------------
    def filename(self, key: StoreKey) -> str:
        """Canonical name for ``key`` — the JSON engine's physical file
        name, and BOTH engines' iteration sort key (so ``keys()`` order
        is byte-identical across backends)."""
        fp, batch, seq = key
        return f"{self.FILE_PREFIX}{fp}_b{int(batch)}_s{int(seq)}.json"

    @staticmethod
    def _key_from_payload(payload: Dict) -> StoreKey:
        fp, batch, seq = payload["key"]
        return (str(fp), int(batch), int(seq))

    # -- subclass hooks (value semantics) ------------------------------------
    def _check_raw(self, raw):
        """Validate a loaded value; raise to mark the record corrupt."""
        return raw

    def _servable(self, raw) -> None:
        """Deep validation at compact time (e.g. the record must load).

        A record that parses but whose value can never be served would
        be re-skipped by every read forever — compaction drops it."""

    def _merge_raw(self, mine: Optional[Dict], theirs: Dict):
        """Union two values -> ``(merged, n_new)``.

        MUST be commutative and idempotent: any merge order across any
        number of stores converges to the same contents."""
        raise NotImplementedError

    def _note_corrupt(self) -> None:
        """Called once per skipped record/file, on every read path."""

    def _on_merge(self, key: StoreKey, n_new: int) -> None:
        """Called after ``merge`` imported ``n_new`` units for ``key``."""

    def _on_split(self, n_removed: int) -> None:
        """Called after ``split`` removed ``n_removed`` keys."""

    # -- engine primitives ---------------------------------------------------
    def get_raw(self, key: StoreKey) -> Optional[Dict]:
        """Validated value for ``key``, or None (corrupt counted)."""
        raise NotImplementedError

    def put_raw(self, key: StoreKey, raw) -> str:
        """Atomically persist ``raw`` under ``key``; returns the path
        the record landed in."""
        raise NotImplementedError

    def _delete_key(self, key: StoreKey) -> bool:
        """Remove ``key`` from this store; True if something was removed."""
        raise NotImplementedError

    def iter_raw(self) -> Iterator[Tuple[StoreKey, Dict]]:
        """(key, value) for every loadable key, in ``filename`` order."""
        raise NotImplementedError

    def __len__(self) -> int:
        raise NotImplementedError

    def clear(self) -> int:
        """Delete every stored key; returns how many were removed."""
        raise NotImplementedError

    def compact(self, max_age_s: Optional[float] = None,
                max_entries: Optional[int] = None) -> Dict[str, int]:
        """Garbage-collect: stale schemas, TTL, entry cap (newest kept)."""
        raise NotImplementedError

    def _purge_unloadable(self) -> int:
        """Drop every record that can no longer be loaded; returns how
        many were dropped (subclass compactors count these)."""
        raise NotImplementedError

    def _reclaim(self) -> None:
        """Engine-specific space reclaim after a subclass pruned values
        in place (no-op for file-per-key; segment rewrite for the log)."""

    # -- inventory -----------------------------------------------------------
    def keys(self) -> Iterator[StoreKey]:
        """Keys of every loadable record (corrupted ones skipped)."""
        for key, _ in self.iter_raw():
            yield key

    def raw_snapshot(self) -> Dict[StoreKey, Dict]:
        """Canonical content view (equality checks across stores)."""
        return dict(self.iter_raw())

    # -- merge ---------------------------------------------------------------
    def merge(self, other: "KVStoreBase",
              keys: Optional[Iterable[StoreKey]] = None) -> int:
        """Union another store's contents into this one.

        Delegates the per-key union to ``_merge_raw``; because that hook
        is commutative and idempotent, ``a.merge(b); a.merge(c)`` yields
        the same contents in any order — the property federated
        multi-host aggregation relies on. ``keys`` restricts the union
        to a slice (unloadable members are skipped, like every read).
        Returns how many units (records / observations) were new to
        this store. (``split`` is the *move* counterpart.)
        """
        if keys is None:
            items: Iterable = other.iter_raw()
        else:
            items = ((k, other.get_raw(k)) for k in keys)
        imported = 0
        for key, theirs in items:
            if theirs is None:
                continue
            imported += self._merge_one(key, theirs)
        return imported

    def _merge_one(self, key: StoreKey, theirs) -> int:
        """Union one foreign value into this store (merge contract)."""
        with self._lock:
            mine = self.get_raw(key)
            merged, n_new = self._merge_raw(mine, theirs)
            if n_new:
                self.put_raw(key, merged)
                self._on_merge(key, n_new)
        return n_new

    # -- slice handoff (live resharding) ------------------------------------
    def extract(self, keys: Iterable[StoreKey]) -> Dict[StoreKey, Dict]:
        """Validated values for exactly ``keys`` (unloadable ones skipped).

        Read-only companion to ``split``: corrupt/foreign records in the
        slice are counted via ``_note_corrupt`` and omitted, never
        raised — the same skip semantics as every other read path.
        """
        out: Dict[StoreKey, Dict] = {}
        for key in keys:
            raw = self.get_raw(key)
            if raw is not None:
                out[key] = raw
        return out

    def split(self, keys: Iterable[StoreKey],
              into: "KVStoreBase") -> Dict[str, int]:
        """Move exactly ``keys`` from this store into ``into``.

        Each key's value is handed off through ``into``'s merge contract
        (so a destination that raced ahead and already holds a value for
        the key converges exactly as a cross-host merge would), then the
        local record is removed — the handoff is copy-then-delete, never
        a window with zero owners on disk. Keys whose local record is
        missing or unloadable are skipped (counted via
        ``_note_corrupt`` by the shared load path) and *left in place*:
        a corrupt record is dead to every reader anyway and ``compact``
        reclaims it; migration never raises because of one.

        Returns ``{"moved": keys removed here, "units": units new to
        the destination, "skipped": keys with no loadable record}``.

        The read→merge→delete sequence for each key holds ``_lock``: a
        concurrent ``put_raw``/``_merge_one`` landing a *newer* value in
        that window would otherwise be deleted unseen. Holding our lock
        while taking ``into``'s (inside ``_merge_one``) nests two store
        locks src→dest; that nesting is deadlock-free because resharding
        runs splits from a single thread (the one-reshard-at-a-time
        guard) and nothing splits in the opposite direction concurrently.
        """
        moved = units = skipped = 0
        for key in keys:
            with self._lock:
                raw = self.get_raw(key)
                if raw is None:
                    skipped += 1
                    continue
                units += into._merge_one(key, raw)
                if self._delete_key(key):
                    moved += 1
        if moved:
            self._on_split(moved)
        return {"moved": moved, "units": units, "skipped": skipped}


class JsonFileStore(KVStoreBase):
    """File-per-key engine: one JSON file per ``StoreKey``."""

    def path_for(self, key: StoreKey) -> str:
        return os.path.join(self.root, self.filename(key))

    def _files(self) -> List[str]:
        try:
            names = os.listdir(self.root)
        except OSError:
            return []
        return sorted(n for n in names
                      if n.startswith(self.FILE_PREFIX)
                      and n.endswith(".json"))

    def _scan_files(self) -> List[Tuple[str, float]]:
        """ONE ``scandir`` pass over the store: sorted ``(name, mtime)``.

        The mtimes ride along from the directory scan itself (cached on
        the ``DirEntry``), so compaction's TTL and entry-cap paths never
        issue a per-file ``os.stat`` — at 10^5 keys the old
        stat-per-file loop dominated every ``compact`` call.
        """
        out: List[Tuple[str, float]] = []
        try:
            with os.scandir(self.root) as it:
                for e in it:
                    name = e.name
                    if not (name.startswith(self.FILE_PREFIX)
                            and name.endswith(".json")):
                        continue
                    try:
                        out.append((name, e.stat().st_mtime))
                    except OSError:
                        pass  # vanished under us: nothing to do
        except OSError:
            return []
        return sorted(out)

    # -- load / save --------------------------------------------------------
    def _load_payload(self, path: str) -> Optional[Dict]:
        """Parsed, validated payload for one key file, or None.

        Skips (counting via ``_note_corrupt``) anything unparseable, on
        a foreign schema version, carrying a malformed value, or whose
        embedded key does not name the very file it was found under —
        the SAME semantics on every read path (get / keys / iter_raw /
        merge / compact), so a renamed or misplaced file is dead
        everywhere, not just to ``get``, and ``compact`` reclaims it.
        A file that simply does not exist is a clean miss, not corrupt.
        """
        try:
            with open(path) as f:
                payload = json.load(f)
            if payload.get("version") != self.schema_version:
                raise ValueError(f"schema version {payload.get('version')!r}")
            payload["key"] = self._key_from_payload(payload)
            if self.filename(payload["key"]) != os.path.basename(path):
                raise ValueError("stored key disagrees with filename")
            payload[self.VALUE_FIELD] = self._check_raw(
                payload.get(self.VALUE_FIELD))
            return payload
        except FileNotFoundError:
            return None
        except (OSError, ValueError, KeyError, TypeError):
            # json.JSONDecodeError is a ValueError; malformed values
            # raise KeyError/TypeError. All are one skipped file.
            self._note_corrupt()
            return None

    def get_raw(self, key: StoreKey) -> Optional[Dict]:
        payload = self._load_payload(self.path_for(key))
        return None if payload is None else payload[self.VALUE_FIELD]

    def put_raw(self, key: StoreKey, raw) -> str:
        """Atomically persist ``raw`` under ``key``; returns the path.

        Serialized under ``_lock`` so a write can never land inside
        another thread's read→merge→delete window (``split`` holds the
        lock across that whole sequence; an unserialized writer there
        would have its value silently unlinked during migration).
        """
        path = self.path_for(key)
        payload = {"version": self.schema_version,
                   "key": [key[0], int(key[1]), int(key[2])],
                   self.VALUE_FIELD: raw}
        with self._lock:
            atomic_write_json(self.root, path, payload)
        return path

    def _delete_key(self, key: StoreKey) -> bool:
        try:
            os.unlink(self.path_for(key))
            return True
        except OSError:
            return False  # a concurrent compact/clear got there first

    # -- inventory ----------------------------------------------------------
    def __len__(self) -> int:
        return len(self._files())

    def iter_raw(self) -> Iterator[Tuple[StoreKey, Dict]]:
        for name in self._files():
            payload = self._load_payload(os.path.join(self.root, name))
            if payload is not None:
                yield payload["key"], payload[self.VALUE_FIELD]

    def clear(self) -> int:
        n = 0
        for name in self._files():
            try:
                os.unlink(os.path.join(self.root, name))
                n += 1
            except OSError:
                pass
        return n

    # -- compaction ---------------------------------------------------------
    def _purge_unloadable(self) -> int:
        """Unlink every file that no longer loads; returns the count."""
        n = 0
        for name in self._files():
            path = os.path.join(self.root, name)
            with self._lock:
                if self._load_payload(path) is None:
                    try:
                        os.unlink(path)
                        n += 1
                    except OSError:
                        pass
        return n

    def compact(self, max_age_s: Optional[float] = None,
                max_entries: Optional[int] = None) -> Dict[str, int]:
        """Garbage-collect the store: stale schemas, TTL, entry cap.

        Drops (1) files carrying a foreign schema generation, that no
        longer parse, or whose value fails ``_servable`` — they can
        never be served, only re-skipped on every read — (2) files
        older than ``max_age_s`` (by mtime; the TTL), and (3) the
        oldest files beyond ``max_entries`` (newest survive). Deletion
        is plain ``unlink``: a concurrent reader either opened the file
        first (and reads the old record) or misses — never a torn read.
        The whole call runs off ONE directory scan (``_scan_files``):
        the TTL/entry-cap paths reuse the scan's cached mtimes instead
        of re-``stat``-ing every file. Returns removal counts by reason
        plus the surviving count.
        """
        now = time.time()
        valid: List[tuple] = []  # (mtime, name) of loadable current-schema
        removed = {"stale_schema": 0, "expired": 0, "over_cap": 0}

        def _unlink(name: str, reason: str) -> None:
            try:
                os.unlink(os.path.join(self.root, name))
                removed[reason] += 1
            except OSError:
                pass  # a concurrent compact/clear got there first

        for name, mtime in self._scan_files():
            path = os.path.join(self.root, name)
            payload = self._load_payload(path)
            if payload is None:
                _unlink(name, "stale_schema")  # vanished files no-op
                continue
            try:
                self._servable(payload[self.VALUE_FIELD])
            except Exception:
                _unlink(name, "stale_schema")
                continue
            if max_age_s is not None and now - mtime > max_age_s:
                _unlink(name, "expired")
                continue
            valid.append((mtime, name))
        if max_entries is not None and len(valid) > max_entries:
            valid.sort()  # oldest first
            doomed, valid = valid[:len(valid) - max_entries], \
                valid[len(valid) - max_entries:]
            for _, name in doomed:
                _unlink(name, "over_cap")
        return {**removed, "removed": sum(removed.values()),
                "kept": len(valid)}


# -- segment log engine -------------------------------------------------------

_SEG_MAGIC = b"\xabKV1"                # record framing sentinel (resync point)
_SEG_HEADER = struct.Struct("<II")     # payload length, CRC32(payload)
_SEG_HDR_LEN = len(_SEG_MAGIC) + _SEG_HEADER.size
# rescans of a directory that another instance keeps changing, before a
# scan is accepted as it stands
_SCAN_ATTEMPTS = 64


class SimulatedCrash(BaseException):
    """Raised by crash-point hooks in fault-injection tests.

    Deliberately NOT an ``Exception``: nothing in the store may catch
    it, so a test crash unwinds the exact instant the hook fires —
    exactly like a ``kill -9`` at that point in the protocol.
    """


class SegmentLogStore(KVStoreBase):
    """Append-only segment-log engine behind the same store contract.

    Physical layout: ``<PREFIX>seg-<NNNNNNNN>.log`` files. Records
    append to the highest-numbered (active) segment, which seals once it
    crosses ``segment_bytes`` — sealing just starts the next segment, so
    sealed segments are immutable. A record is::

        MAGIC(4) | payload_len(4, LE) | crc32(payload)(4, LE) | payload

    where the payload is ``<header JSON>\\n<value JSON>``: the header
    carries the shared schema version, the key, the append timestamp
    (the TTL axis; file mtime is meaningless in a log), and
    ``deleted: true`` for tombstones (which carry no value part).
    Deletion appends a tombstone, so the delete itself survives a crash
    and an older segment can never resurrect the key.

    Open rebuilds the in-memory ``key -> (segment, offset)`` index by
    scanning segments newest-first: the first (newest) record seen per
    key wins, tombstones kill the key, and within one segment the later
    record overrides the earlier. Corrupt-skip is per-record: a torn
    tail in the newest segment (crash mid-append) is truncated —
    unacknowledged by construction, never fatal — while a corrupt
    mid-segment record is skipped alone (the scanner resyncs on the next
    MAGIC) and counted via ``_note_corrupt``.

    ``compact`` rewrites live records into fresh segments numbered
    *above* the current active one, then retires (unlinks) every old
    segment. A crash anywhere in that window leaves old + new segments
    side by side; the newest-first scan dedupes, so reopening loses
    nothing and a retried compact converges.

    ``_crash_hook`` is the fault-injection seam: when set, it is called
    with a site name at every protocol step boundary (``append_mid``,
    ``append_durable``, ``seal``, ``compact_rewrite``,
    ``compact_retire``) and may raise :class:`SimulatedCrash` to
    simulate dying right there — the crash-point tests in
    ``tests/test_store_engines.py`` drive every site.
    """

    SEGMENT_BYTES = 4 << 20  # seal threshold for the active segment

    def __init__(self, root: str, segment_bytes: Optional[int] = None,
                 fsync: bool = False):
        super().__init__(root)
        self.segment_bytes = int(segment_bytes or self.SEGMENT_BYTES)
        self.fsync = bool(fsync)
        self._clock: Callable[[], float] = time.time  # test seam (TTL axis)
        self._crash_hook: Optional[Callable[[str], None]] = None
        # key -> (seg_name, seg_no, payload_offset, payload_len, ts);
        # built lazily so subclass __init__ (stats objects the corrupt
        # counter writes into) completes before the first scan runs
        self._index: Optional[Dict[StoreKey, tuple]] = None
        self._active_no = 0
        self._active_f = None
        self._active_size = 0
        # file-order record table of the ACTIVE segment, maintained
        # incrementally by the append path; persisted as the segment's
        # hint file the moment it seals
        self._active_records: List[tuple] = []
        self._dir_mtime = -2      # freshness fingerprint (_ensure_fresh)
        self._scanned: List[Tuple[int, str]] = []  # segments the index holds
        self.torn_truncated = 0   # tail records truncated at open
        self.sealed_segments = 0  # segments sealed by this instance

    # -- crash seam ----------------------------------------------------------
    def _fire_crash(self, site: str) -> None:
        hook = self._crash_hook
        if hook is not None:
            hook(site)

    # -- segment file mapping -----------------------------------------------
    def path_for(self, key: StoreKey) -> str:
        """Physical file currently holding ``key``'s record — the
        companion to ``JsonFileStore.path_for``, for layout
        introspection and fault injection. Here that is the containing
        *segment* (the active segment for unknown keys): mutating it
        touches every record in that segment, not just ``key``'s."""
        with self._lock:
            self._ensure_fresh()
            entry = self._index.get(key)
            no = self._active_no if entry is None else entry[1]
        return self._seg_path(no)

    def _seg_name(self, no: int) -> str:
        return f"{self.FILE_PREFIX}seg-{int(no):08d}.log"

    def _seg_path(self, no: int) -> str:
        return os.path.join(self.root, self._seg_name(no))

    def _seg_files(self) -> List[Tuple[int, str]]:
        """``(number, name)`` for every segment of THIS store's prefix,
        oldest first."""
        prefix = f"{self.FILE_PREFIX}seg-"
        out: List[Tuple[int, str]] = []
        try:
            names = os.listdir(self.root)
        except OSError:
            return []
        for name in names:
            if not (name.startswith(prefix) and name.endswith(".log")):
                continue
            digits = name[len(prefix):-len(".log")]
            if digits.isdigit():
                out.append((int(digits), name))
        return sorted(out)

    def _files(self) -> List[str]:
        """Segment file names, oldest first (layout introspection)."""
        return [name for _, name in self._seg_files()]

    # -- hint files (sealed-segment record tables) ---------------------------
    # When a segment seals (or compaction finishes writing one), its
    # record table is persisted next to it as ``<segment>.idx`` so a
    # later open loads the tiny table instead of re-scanning megabytes
    # of record bytes. Hints are pure caches: they are written
    # atomically, validated against the segment's exact byte size, and
    # ANY doubt (missing, unparseable, foreign version, size mismatch —
    # e.g. a writer this instance never saw) falls back to the full
    # CRC scan. Losing a hint can only cost time, never data.
    def _hint_path(self, no: int) -> str:
        return self._seg_path(no) + ".idx"

    def _write_hint(self, no: int, size: int, records: List[tuple]) -> None:
        payload = {"version": self.schema_version, "size": int(size),
                   "records": [[list(key), off, length, ts, bool(deleted)]
                               for key, off, length, ts, deleted in records]}
        try:
            atomic_write_json(self.root, self._hint_path(no), payload)
        except OSError:
            pass  # a missing hint only costs the next open a rescan

    def _load_hint(self, no: int) -> Optional[List[tuple]]:
        try:
            with open(self._hint_path(no)) as f:
                obj = json.load(f)
            if obj.get("version") != self.schema_version:
                return None
            if int(obj["size"]) != os.path.getsize(self._seg_path(no)):
                return None  # stale: someone wrote past the seal
            out = []
            for (fp, batch, seq), off, length, ts, deleted in obj["records"]:
                out.append(((str(fp), int(batch), int(seq)), int(off),
                            int(length), float(ts), bool(deleted)))
            return out
        except (OSError, ValueError, KeyError, TypeError):
            return None

    # -- record codec --------------------------------------------------------
    # A record payload is ``<header JSON>\n<value JSON>`` (no value part
    # for tombstones). The header carries only version/key/ts/deleted,
    # so the open-time index scan parses a few dozen bytes per record
    # regardless of value size — cold start stays O(keys), not O(bytes
    # of values). ``json.dumps`` emits no raw newlines (ensure_ascii
    # escapes everything), so the first ``\n`` always splits correctly.
    def _encode(self, key: StoreKey, raw=None, deleted: bool = False,
                ts: Optional[float] = None) -> Tuple[bytes, float]:
        when = float(self._clock() if ts is None else ts)
        header: Dict = {"version": self.schema_version,
                        "key": [key[0], int(key[1]), int(key[2])],
                        "ts": when}
        if deleted:
            header["deleted"] = True
            return json.dumps(header, sort_keys=True).encode("utf-8"), when
        return (json.dumps(header, sort_keys=True).encode("utf-8") + b"\n"
                + json.dumps(raw, sort_keys=True).encode("utf-8")), when

    @staticmethod
    def _split_payload(blob: bytes) -> Tuple[bytes, Optional[bytes]]:
        nl = blob.find(b"\n")
        if nl == -1:
            return blob, None
        return blob[:nl], blob[nl + 1:]

    def _decode_blob(self, blob: bytes, key: StoreKey):
        """Validated value from one record payload; raises when the
        record is foreign-versioned, malformed, a tombstone, or embeds a
        key that disagrees with the index — the same skip semantics the
        JSON engine applies per file, here applied per record."""
        head, value = self._split_payload(blob)
        obj = json.loads(head.decode("utf-8"))
        if obj.get("version") != self.schema_version:
            raise ValueError(f"schema version {obj.get('version')!r}")
        if self._key_from_payload(obj) != key:
            raise ValueError("stored key disagrees with index")
        if obj.get("deleted"):
            raise ValueError("tombstone record")
        if value is None:
            raise ValueError("record carries no value")
        return self._check_raw(json.loads(value.decode("utf-8")))

    # -- open / index rebuild ------------------------------------------------
    def _ensure_open(self) -> None:
        if self._index is None:
            self._open()

    def _ensure_fresh(self) -> None:
        """Rescan if ANOTHER process changed the directory under us.

        The index is process-local; the JSON engine picks up foreign
        writes for free by re-listing the directory on every read, so
        the contract requires the same here (the RPC frontend keeps
        local handles over directories its child processes write). Two
        ``stat`` calls — directory mtime catches created/retired
        segments, active-segment size catches appends (our own appends
        keep ``_active_size`` exact, so they never trigger a rescan) —
        instead of a full re-list per read.
        """
        if self._index is None:
            self._open()
            return
        try:
            dir_mtime = os.stat(self.root).st_mtime_ns
        except OSError:
            dir_mtime = -1
        if dir_mtime != self._dir_mtime:
            self._reopen()
            self._open()
            return
        try:
            size = os.path.getsize(self._seg_path(self._active_no))
        except OSError:
            size = -1
        if size != self._active_size:
            self._reopen()
            self._open()

    def _stat_dir(self) -> int:
        try:
            return os.stat(self.root).st_mtime_ns
        except OSError:
            return -1

    def _reopen(self) -> None:
        """Drop the index and handles; the next access rescans disk."""
        with self._lock:
            if self._active_f is not None:
                try:
                    self._active_f.close()
                except OSError:
                    pass
            self._active_f = None
            self._index = None

    def _open(self) -> None:
        """Rebuild the index by scanning segments newest-first.

        Another instance's ``compact`` may create and retire segments
        while this scan lists and reads them. A scan is accepted only when
        the directory it listed (names and mtime) is the one it ends on and
        the newest listed segment could be opened for append; otherwise it
        runs again, so a rescan never drops a record that a concurrent
        compaction moved, and never re-creates a retired segment.
        """
        for _ in range(_SCAN_ATTEMPTS):
            mtime, files = self._stat_dir(), self._seg_files()
            scan = self._scan_dir(files, create=not files)
            if scan is not None and (self._stat_dir(),
                                     self._seg_files()) == (mtime, files):
                break
            if scan is not None:
                scan[2].close()
        else:
            # the directory never held still: take one scan as it stands
            mtime, files = self._stat_dir(), self._seg_files()
            scan = self._scan_dir(files, create=True)
        index, active_no, active_f, active_records = scan
        self._scanned = files
        self._index = index
        self._active_no = active_no
        self._active_f = active_f
        self._active_size = os.fstat(active_f.fileno()).st_size
        self._active_records = active_records
        self._dir_mtime = mtime

    def _scan_dir(self, files: List[Tuple[int, str]], create: bool):
        """One newest-first scan of ``files``: ``(index, active_no,
        active_f, active_records)``, or None when the newest segment
        vanished before it could be opened for append (``create=False``)."""
        index: Dict[StoreKey, tuple] = {}
        seen: set = set()
        active_records: List[tuple] = []
        for no, name in reversed(files):
            path = os.path.join(self.root, name)
            newest = no == files[-1][0]
            if not newest:
                # sealed segments are immutable: a validated hint file
                # replaces the byte scan entirely
                records = self._load_hint(no)
                if records is None:
                    records, _, _ = self._scan_segment(path)
            else:
                records, good_end, torn = self._scan_segment(path)
                if torn:
                    # only the segment that was active at the crash can
                    # carry a legitimately torn (unacknowledged) tail
                    records = self._truncate_torn(path, records)
                active_records = list(records)
            # within one segment the LAST record per key wins...
            last: Dict[StoreKey, tuple] = {}
            for rec in records:
                last[rec[0]] = rec
            # ...and across segments the NEWEST segment wins; a
            # tombstone anywhere newer kills every older record
            for key, (_, off, length, ts, deleted) in last.items():
                if key in seen:
                    continue
                seen.add(key)
                if not deleted:
                    index[key] = (name, no, off, length, ts)
        active_no = files[-1][0] if files else 1
        path = self._seg_path(active_no)
        try:
            if create:
                active_f = open(path, "ab")
            else:
                # no O_CREAT: a segment retired since the listing must
                # not come back as an empty stray
                active_f = os.fdopen(os.open(path, os.O_WRONLY | os.O_APPEND),
                                     "ab")
        except FileNotFoundError:
            return None
        return index, active_no, active_f, active_records

    def _truncate_torn(self, path: str, records: List[tuple]) -> List[tuple]:
        """Cut a torn tail off ``path``, unless a writer still holds it.

        Every writer (another instance's append or compaction rewrite)
        holds an ``flock`` on the segment while its record is partly on
        disk, so a tail that cannot be locked is in flight, not torn: it
        is left alone and its record stays out of the index until the
        writer finishes. Under the lock the segment is scanned again,
        since the writer may have finished in between.
        """
        try:
            with open(path, "r+b") as f:
                try:
                    fcntl.flock(f.fileno(), fcntl.LOCK_EX | fcntl.LOCK_NB)
                except BlockingIOError:
                    return records
                records, good_end, torn = self._scan_segment(path)
                if torn:
                    f.truncate(good_end)
                    self.torn_truncated += 1
        except OSError:
            pass
        return records

    def _scan_segment(self, path: str):
        """Walk one segment's records: ``(records, good_end, torn)``.

        ``records`` is ``(key, payload_off, payload_len, ts, deleted)``
        in file order; ``good_end`` is the byte offset after the last
        structurally complete record (the truncation point for a torn
        tail); ``torn`` reports an incomplete record at EOF. A corrupt
        record *followed by more data* skips only itself: the scanner
        resyncs on the next MAGIC and counts it via ``_note_corrupt``.
        """
        try:
            with open(path, "rb") as f:
                data = f.read()
        except OSError:
            return [], 0, False
        records: List[tuple] = []
        size = len(data)
        mv = memoryview(data)  # CRC/header reads without per-record copies
        pos = good_end = 0
        torn = False
        while pos < size:
            if size - pos < _SEG_HDR_LEN:
                torn = True  # partial header at EOF
                break
            if data[pos:pos + 4] != _SEG_MAGIC:
                nxt = data.find(_SEG_MAGIC, pos + 1)
                if nxt == -1:
                    torn = True  # trailing garbage, no later record
                    break
                self._note_corrupt()  # mid-segment junk: skip only it
                pos = nxt
                continue
            length, crc = _SEG_HEADER.unpack_from(data, pos + 4)
            start = pos + _SEG_HDR_LEN
            end = start + length
            if end > size:
                nxt = data.find(_SEG_MAGIC, pos + 4)
                if nxt == -1:
                    torn = True  # record ran off EOF: torn tail
                    break
                self._note_corrupt()  # bad length mid-segment: resync
                pos = nxt
                continue
            if zlib.crc32(mv[start:end]) != crc:
                self._note_corrupt()
                nxt = data.find(_SEG_MAGIC, pos + 4)
                if nxt == -1:
                    break  # corrupt final record: dead, but acked bytes
                pos = nxt  # stay — compact reclaims them
                continue
            nl = data.find(b"\n", start, end)
            head_end = end if nl == -1 else nl
            try:
                # header-only parse: scan cost is independent of value size
                obj = json.loads(data[start:head_end].decode("utf-8"))
                if obj.get("version") != self.schema_version:
                    raise ValueError("foreign schema version")
                key = self._key_from_payload(obj)
                ts = float(obj.get("ts", 0.0))
                deleted = bool(obj.get("deleted"))
            except (ValueError, KeyError, TypeError, UnicodeDecodeError):
                self._note_corrupt()
                pos = good_end = end  # framing intact: skip one record
                continue
            records.append((key, start, length, ts, deleted))
            pos = good_end = end
        return records, good_end, torn

    # -- append path ---------------------------------------------------------
    def _append_blob(self, blob: bytes) -> int:
        """Append one framed record; returns the payload offset.

        The write is split in two flushes around the ``append_mid``
        crash site so a simulated crash leaves a genuinely torn record
        on disk — exactly what a real mid-``write`` kill produces.
        """
        rec = (_SEG_MAGIC + _SEG_HEADER.pack(len(blob), zlib.crc32(blob))
               + blob)
        f = self._active_f
        offset = self._active_size
        half = max(1, len(rec) // 2)
        # held while the record is partly on disk: another instance's
        # rescan must not take the half-written record for a torn tail
        fcntl.flock(f.fileno(), fcntl.LOCK_EX)
        try:
            f.write(rec[:half])
            f.flush()
            self._fire_crash("append_mid")
            f.write(rec[half:])
            f.flush()
            if self.fsync:
                os.fsync(f.fileno())
        finally:
            fcntl.flock(f.fileno(), fcntl.LOCK_UN)
        self._active_size += len(rec)
        return offset + _SEG_HDR_LEN

    def _seal(self) -> None:
        """Seal the active segment: start the next one.

        Sealed segments are immutable from here on; the ``seal`` crash
        site sits after the new segment exists on disk but before the
        writer state swaps to it — a crash there reopens cleanly (the
        empty newest segment scans as empty and the old active keeps
        its records).
        """
        f = self._active_f
        f.flush()
        if self.fsync:
            os.fsync(f.fileno())
        # the segment is now immutable: persist its record table so the
        # next open loads the hint instead of re-scanning the bytes
        self._write_hint(self._active_no, self._active_size,
                         self._active_records)
        nxt_no = self._active_no + 1
        nxt_f = open(self._seg_path(nxt_no), "ab")
        try:
            self._fire_crash("seal")
        except BaseException:
            nxt_f.close()
            raise
        f.close()
        self._active_f, self._active_no = nxt_f, nxt_no
        self._active_size = 0
        self._active_records = []
        self.sealed_segments += 1
        self._dir_mtime = self._stat_dir()

    def put_raw(self, key: StoreKey, raw) -> str:
        with self._lock:
            self._ensure_fresh()
            blob, ts = self._encode(key, raw=raw)
            off = self._append_blob(blob)
            # record is durable; index not yet updated (= not yet acked)
            self._fire_crash("append_durable")
            self._index[key] = (self._seg_name(self._active_no),
                                self._active_no, off, len(blob), ts)
            self._active_records.append((key, off, len(blob), ts, False))
            path = self._seg_path(self._active_no)
            if self._active_size >= self.segment_bytes:
                self._seal()
        return path

    def _delete_key(self, key: StoreKey) -> bool:
        with self._lock:
            self._ensure_fresh()
            if key not in self._index:
                return False
            blob, ts = self._encode(key, deleted=True)
            off = self._append_blob(blob)
            self._fire_crash("append_durable")
            del self._index[key]
            self._active_records.append((key, off, len(blob), ts, True))
            if self._active_size >= self.segment_bytes:
                self._seal()
        return True

    # -- read path -----------------------------------------------------------
    def _read_blob(self, entry: tuple) -> Optional[bytes]:
        name, _no, off, length, _ts = entry
        try:
            with open(os.path.join(self.root, name), "rb") as f:
                f.seek(off)
                blob = f.read(length)
        except OSError:
            return None
        return blob if len(blob) == length else None

    def get_raw(self, key: StoreKey) -> Optional[Dict]:
        with self._lock:
            self._ensure_fresh()
            failed = None
            for _ in range(_SCAN_ATTEMPTS):
                entry = self._index.get(key)
                if entry is None:
                    return None
                blob = self._read_blob(entry)
                if blob is None:
                    if entry == failed:
                        return None  # a fresh scan points at it again
                    # segment retired under us (another instance's
                    # compaction): rescan, and read where it points now
                    failed = entry
                    self._reopen()
                    self._ensure_open()
                    continue
                try:
                    return self._decode_blob(blob, key)
                except (ValueError, KeyError, TypeError,
                        UnicodeDecodeError):
                    self._note_corrupt()
                    self._index.pop(key, None)  # dead: compact reclaims
                    return None
        return None

    def iter_raw(self) -> Iterator[Tuple[StoreKey, Dict]]:
        """(key, value) in ``filename`` order — byte-identical iteration
        order to the JSON engine. Each segment's bytes are read ONCE
        (the single-scan discipline), not once per record."""
        with self._lock:
            self._ensure_fresh()
            items = sorted(self._index.items(),
                           key=lambda kv: self.filename(kv[0]))
        cache: Dict[str, bytes] = {}
        for key, entry in items:
            name, _no, off, length, _ts = entry
            data = cache.get(name)
            if data is None:
                try:
                    with open(os.path.join(self.root, name), "rb") as f:
                        data = f.read()
                except OSError:
                    data = b""
                cache[name] = data
            blob = data[off:off + length]
            if len(blob) != length:
                raw = self.get_raw(key)  # retired mid-iteration: re-resolve
            else:
                try:
                    raw = self._decode_blob(blob, key)
                except (ValueError, KeyError, TypeError,
                        UnicodeDecodeError):
                    self._note_corrupt()
                    raw = None
            if raw is not None:
                yield key, raw

    # -- inventory -----------------------------------------------------------
    def __len__(self) -> int:
        with self._lock:
            self._ensure_fresh()
            return len(self._index)

    def clear(self) -> int:
        with self._lock:
            self._ensure_fresh()
            n = len(self._index)
            if self._active_f is not None:
                try:
                    self._active_f.close()
                except OSError:
                    pass
            for no, name in self._seg_files():
                for victim in (os.path.join(self.root, name),
                               self._hint_path(no)):
                    try:
                        os.unlink(victim)
                    except OSError:
                        pass
            self._index = {}
            self._active_no += 1  # fresh segment: never reuse a number
            path = self._seg_path(self._active_no)
            self._active_f = open(path, "ab")
            self._active_size = 0
            self._active_records = []
            self._dir_mtime = self._stat_dir()
        return n

    # -- compaction ----------------------------------------------------------
    def _purge_unloadable(self) -> int:
        """Drop every indexed record that no longer validates (CRC,
        schema, value check); returns the count. Physical reclaim
        happens at the next rewrite (``_reclaim``/``compact``)."""
        with self._lock:
            self._ensure_open()
            n = 0
            for key in list(self._index):
                if self.get_raw(key) is None:  # drops + counts corrupt
                    n += 1
            return n

    def _reclaim(self) -> None:
        # subclasses override compact() with value-level pruning (e.g.
        # FeedbackStore); name the engine's compactor explicitly so the
        # rewrite that reclaims dead bytes still runs
        SegmentLogStore.compact(self)

    def compact(self, max_age_s: Optional[float] = None,
                max_entries: Optional[int] = None) -> Dict[str, int]:
        """Rewrite live records into fresh segments, retire the old.

        Same policy surface as the JSON engine: drops records that no
        longer validate or fail ``_servable`` (``stale_schema``),
        records older than ``max_age_s`` by their append timestamp
        (``expired``), and the oldest beyond ``max_entries`` — newest
        always survive (``over_cap``). Survivors are re-encoded with
        their ORIGINAL timestamps (age survives compaction) into
        segments numbered above the active one, then every pre-existing
        segment is unlinked. The ``compact_rewrite`` /
        ``compact_retire`` crash sites bracket the rewrite: a crash
        before retire leaves old + new segments side by side, and the
        newest-first open scan dedupes — nothing live is ever lost.
        Each old segment's bytes are read once (no per-record opens).
        """
        with self._lock:
            now = self._clock()
            for _ in range(_SCAN_ATTEMPTS):
                # every listed segment is retired below, so the index must
                # be built from exactly those, each still readable: a
                # stale index would drop (and retire) records that another
                # instance appended or moved
                self._reopen()
                self._open()
                old_files = self._seg_files()
                cache = self._read_segments(old_files)
                if cache is not None and old_files == self._scanned:
                    break
            else:
                raise RuntimeError(f"{self.root}: segments kept changing "
                                   "under compaction")
            removed = {"stale_schema": 0, "expired": 0, "over_cap": 0}
            live: List[tuple] = []  # (ts, seg_no, off, key, raw)
            for key, entry in sorted(self._index.items(),
                                     key=lambda kv: self.filename(kv[0])):
                name, no, off, length, ts = entry
                blob = cache.get(name, b"")[off:off + length]
                try:
                    if len(blob) != length:
                        raise ValueError("record out of bounds")
                    raw = self._decode_blob(blob, key)
                    self._servable(raw)
                except Exception:
                    self._note_corrupt()
                    removed["stale_schema"] += 1
                    continue
                if max_age_s is not None and now - ts > max_age_s:
                    removed["expired"] += 1
                    continue
                live.append((ts, no, off, key, raw))
            if max_entries is not None and len(live) > max_entries:
                live.sort()  # append-time order; offsets break ts ties
                removed["over_cap"] += len(live) - max_entries
                live = live[len(live) - max_entries:]
            # rewrite survivors into fresh segments ABOVE the active one
            old_active = self._active_f
            no = self._active_no + 1
            f = self._open_rewrite(no)
            size = 0
            new_index: Dict[StoreKey, tuple] = {}
            seg_records: List[tuple] = []
            for ts, _old_no, _off, key, raw in sorted(
                    live, key=lambda e: self.filename(e[3])):
                blob, _ = self._encode(key, raw=raw, ts=ts)
                rec = (_SEG_MAGIC
                       + _SEG_HEADER.pack(len(blob), zlib.crc32(blob))
                       + blob)
                f.write(rec)
                new_index[key] = (self._seg_name(no), no,
                                  size + _SEG_HDR_LEN, len(blob), ts)
                seg_records.append((key, size + _SEG_HDR_LEN, len(blob),
                                    ts, False))
                size += len(rec)
                if size >= self.segment_bytes:
                    f.flush()
                    if self.fsync:
                        os.fsync(f.fileno())
                    f.close()
                    # this rewrite segment is sealed: hint it like any
                    # other immutable segment
                    self._write_hint(no, size, seg_records)
                    self._fire_crash("compact_rewrite")
                    no += 1
                    f = self._open_rewrite(no)
                    size = 0
                    seg_records = []
            f.flush()
            if self.fsync:
                os.fsync(f.fileno())
            # new segments are durable; old ones still on disk — a crash
            # here reopens to the same live contents (newest wins)
            try:
                self._fire_crash("compact_retire")
            except BaseException:
                f.close()
                raise
            if old_active is not None:
                try:
                    old_active.close()
                except OSError:
                    pass
            for old_no, name in old_files:
                for victim in (os.path.join(self.root, name),
                               self._hint_path(old_no)):
                    try:
                        os.unlink(victim)
                    except OSError:
                        pass
            fcntl.flock(f.fileno(), fcntl.LOCK_UN)  # fully written
            self._index = new_index
            self._active_f, self._active_no, self._active_size = f, no, size
            self._active_records = seg_records
            self._dir_mtime = self._stat_dir()
            return {**removed, "removed": sum(removed.values()),
                    "kept": len(live)}

    def _open_rewrite(self, no: int):
        """A fresh segment for compaction to write, locked until written:
        a concurrent rescan must not truncate it mid-rewrite."""
        f = open(self._seg_path(no), "ab")
        fcntl.flock(f.fileno(), fcntl.LOCK_EX)
        return f

    def _read_segments(self, files: List[Tuple[int, str]]
                       ) -> Optional[Dict[str, bytes]]:
        """Every listed segment's bytes, each read once; None when one of
        them was retired before it could be read."""
        cache: Dict[str, bytes] = {}
        for _no, name in files:
            try:
                with open(os.path.join(self.root, name), "rb") as f:
                    cache[name] = f.read()
            except FileNotFoundError:
                return None
            except OSError:
                cache[name] = b""
        return cache


# -- backend registry ---------------------------------------------------------

STORE_BACKENDS = {"json": JsonFileStore, "segment": SegmentLogStore}


def store_backend(name: Optional[str] = None) -> str:
    """Resolve a backend name: explicit arg > ``REPRO_STORE_BACKEND``
    env var > ``"json"`` (the historical layout). Raises on unknown
    names so a typo'd env var fails loudly at store construction, not
    silently at first read."""
    resolved = (name or os.environ.get("REPRO_STORE_BACKEND") or
                "json").strip().lower()
    if resolved not in STORE_BACKENDS:
        raise ValueError(f"unknown store backend {resolved!r} "
                         f"(expected one of {sorted(STORE_BACKENDS)})")
    return resolved
