"""reqlog — bounded per-request flight recorder with JSONL export
(counterpart of flexflow_tpu/obs/reqlog.py; the same `ff.reqlog/v1`
schema, so either package reads the other's logs).

One record per completed request carrying its lifecycle timestamps
(arrival / admission / first token / finish, time.monotonic in ns), the
prompt's LENGTH and content-hash prefix chain (never the raw tokens —
the chain is the paged pool's sha1 page-block chain, so two records
share a chain prefix iff their prompts shared those pages), sampling
params, the pool's kv dtype, speculative proposed/accepted counts,
preemptions and peak pages held, and a per-phase queue/prefill/decode
breakdown derived from the stamps.

Cheap enough to leave ON: one dict append per COMPLETED request
(nothing per tick), bounded by a ring. The disabled path is a no-op:
`request_log(0)` returns the shared falsy `NULL_REQLOG` singleton, and
call sites guard record construction with `if rl:` so a disabled server
allocates nothing.
"""

from __future__ import annotations

import gzip
import json
import threading
from collections import deque
from typing import Iterable, Iterator, List, Optional

# bump when a record's field set changes incompatibly; the JSONL header
# line carries it so a replay of a future log fails loudly, not subtly
SCHEMA = "ff.reqlog/v1"

DEFAULT_CAPACITY = 4096


class BoundedRing:
    """THE bounded-retention code path: a keep-newest ring that COUNTS
    what it drops. Shared by the server's per-request metric records
    (`request_record_limit`) and the reqlog ring, and the drop counters
    ride the /v2 metrics payload — silent truncation is visible.

    Internally locked: appends happen on the serving loop thread while
    snapshots run on scrape threads, and iterating a deque that another
    thread is appending to raises RuntimeError. Readers get a consistent
    list copy."""

    __slots__ = ("_ring", "_lock", "dropped")

    def __init__(self, capacity: int):
        capacity = int(capacity)
        if capacity < 1:
            raise ValueError(f"ring capacity must be >= 1, got {capacity}")
        self._ring: deque = deque(maxlen=capacity)
        self._lock = threading.Lock()
        self.dropped = 0

    @property
    def capacity(self) -> int:
        return self._ring.maxlen

    def append(self, item) -> None:
        with self._lock:
            if len(self._ring) == self._ring.maxlen:
                self.dropped += 1
            self._ring.append(item)

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)

    def __iter__(self) -> Iterator:
        return iter(self.snapshot())

    def snapshot(self) -> List:
        with self._lock:
            return list(self._ring)

    def tail(self, n: int) -> List:
        if n <= 0:
            return []
        with self._lock:
            return list(self._ring)[-n:]


class _NullRequestLog:
    """Falsy no-op stand-in when request logging is disabled — shared
    singleton, so the disabled path allocates nothing."""

    __slots__ = ()

    def __bool__(self) -> bool:
        return False

    def log(self, record) -> None:
        pass

    @property
    def dropped(self) -> int:
        return 0

    @property
    def capacity(self) -> int:
        return 0

    def __len__(self) -> int:
        return 0

    def records(self) -> List[dict]:
        return []

    def tail(self, n: int) -> List[dict]:
        return []

    def export_jsonl(self, path: str) -> int:
        return 0


NULL_REQLOG = _NullRequestLog()


class RequestLog:
    """Bounded flight recorder of completed-request records. Appends
    happen on the serving loop thread; snapshots/export may run on any
    thread — the BoundedRing is internally locked, so readers always
    see a consistent list copy."""

    __slots__ = ("_ring",)

    def __init__(self, capacity: int = DEFAULT_CAPACITY):
        self._ring = BoundedRing(capacity)

    def __bool__(self) -> bool:
        return True

    def __len__(self) -> int:
        return len(self._ring)

    @property
    def dropped(self) -> int:
        return self._ring.dropped

    @property
    def capacity(self) -> int:
        return self._ring.capacity

    def log(self, record: dict) -> None:
        self._ring.append(record)

    def records(self) -> List[dict]:
        return self._ring.snapshot()

    def tail(self, n: int) -> List[dict]:
        return self._ring.tail(n)

    def export_jsonl(self, path: str) -> int:
        """Write the retained records as JSONL (a schema header line,
        then one record per line); returns the record count."""
        return dump_jsonl(path, self.records())


def request_log(capacity: Optional[int]):
    """A live RequestLog, or the shared falsy NULL_REQLOG when
    `capacity` is 0 (None means the default capacity)."""
    if capacity is None:
        return RequestLog(DEFAULT_CAPACITY)
    capacity = int(capacity)
    if capacity == 0:
        return NULL_REQLOG
    return RequestLog(capacity)


def _open(path: str, mode: str):
    if str(path).endswith(".gz"):
        return gzip.open(path, mode + "t")
    return open(path, mode)


def dump_jsonl(path: str, records: Iterable[dict]) -> int:
    """Export records to JSONL (gz-aware): first line is the schema
    header, each following line one record. Returns the record count."""
    n = 0
    with _open(path, "w") as f:
        f.write(json.dumps({"schema": SCHEMA}) + "\n")
        for rec in records:
            f.write(json.dumps(rec, sort_keys=True) + "\n")
            n += 1
    return n


def load_jsonl(path: str) -> List[dict]:
    """Import a reqlog JSONL export (gz-aware). Tolerates a missing
    header (hand-built fixtures) but refuses a FOREIGN schema by name."""
    out: List[dict] = []
    with _open(path, "r") as f:
        for i, line in enumerate(f):
            line = line.strip()
            if not line:
                continue
            doc = json.loads(line)
            if i == 0 and "schema" in doc and "submit_ns" not in doc:
                if doc["schema"] != SCHEMA:
                    raise ValueError(
                        f"{path}: schema {doc['schema']!r} is not {SCHEMA!r}")
                continue
            out.append(doc)
    return out
