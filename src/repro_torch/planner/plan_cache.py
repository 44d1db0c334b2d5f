"""Fingerprint-keyed plan cache: pay preprocessing once, serve it forever.

A :class:`Plan` is the full output of preprocessing — the chosen
(reorder, scheme), the row permutation, the cluster boundaries and the
timings that justified the choice. The cache keys plans by
``(pattern fingerprint, reuse bucket, workload, PLAN_CACHE_VERSION)``:

* the *fingerprint* (see :func:`repro_torch.planner.features.fingerprint`) is
  value-independent, so re-serving the same sparsity pattern with new
  numeric values is a hit;
* the *reuse bucket* (log-decade of the caller's ``reuse_hint``) keeps
  single-shot plans (identity) from shadowing high-reuse plans (clustered)
  for the same matrix;
* the *workload* (``a2`` sparse×sparse, ``spmm`` tall-skinny, ``chain``
  one hop of A^k, ``batch`` a block-diagonal pack of several requests)
  keeps a plan measured on one kernel family from serving the other — the
  SpMM menu (``spmm_*``, ``cluster_spmm_compact``) has different
  economics than the A² menu, and a pack whose pattern collides with a
  single request's fingerprint still plans apart;
* the *version* is bumped whenever plan semantics change, like
  ``benchlib``'s kernel-generation cache key — a stale on-disk plan from
  an older planner can never be served.

Storage: LRU-ordered in-memory dict in front of an optional on-disk
directory of ``.npz`` files (permutation + boundaries arrays, JSON metadata
sidecar in the same archive). ``max_bytes`` caps the store: inserting past
the budget evicts least-recently-used plans from memory *and disk* (the
multi-tenant serving fix for the previously unbounded on-disk growth).
Everything is a plain file per key — no index to corrupt, safe to delete
at any time.

**Crash safety**: every entry embeds a blake2b checksum of its
payload; writes go through a unique temp file + ``os.replace`` (fsync'd,
so a crash mid-write can never leave a truncated ``.npz`` under the live
name); and a corrupt, truncated, checksum-mismatched or
version-mismatched disk entry is treated as **miss-plus-evict** — the
damaged file is deleted, the ``plan_cache_corrupt`` metric incremented,
and planning proceeds as a normal miss — never as an unpickling
exception on the serving path. ``_scan_disk`` applies the same
discipline at construction: stale ``*.tmp`` files and unreadable entries
are removed before they can be served.

**Namespaces** (per-tenant isolation): ``PlanCache(namespace="tenant-a")``
prefixes every key (and on-disk filename, ``ns-<namespace>_…``) and scopes
the LRU byte budget to that namespace — the disk scan only accounts, and
eviction only ever deletes, files of its own namespace, so one traffic
source flooding the cache cannot evict another tenant's hot plans even
when all tenants share one directory. The default namespace (``""``)
owns the un-prefixed files and likewise never touches namespaced ones.
"""
from __future__ import annotations

import dataclasses
import hashlib
import io
import json
import math
import os
import tempfile
import threading
from collections import OrderedDict

import numpy as np

from repro_torch.resilience import faults as _faults
from repro_torch.resilience.errors import CorruptPlanError

__all__ = ["Plan", "PlanCache", "PLAN_CACHE_VERSION", "reuse_bucket",
           "DEFAULT_CACHE_DIR", "DEFAULT_MAX_BYTES"]

# v3: checksummed crash-safe entries (v2: workload keys + pallas scheme)
PLAN_CACHE_VERSION = "plan-v3"

DEFAULT_CACHE_DIR = os.path.join(
    os.path.dirname(__file__), "..", "..", "..", "experiments", "plan_cache_torch")

# default byte budget of the process-wide serving cache (plans are a perm
# + boundaries — even 1M-row plans are ~8 MB, so this holds dozens of hot
# tenants while bounding the on-disk store)
DEFAULT_MAX_BYTES = 256 * 2**20


def reuse_bucket(reuse_hint: int) -> int:
    """Log-decade bucket: 1 → 0, 2–9 → 1, 10–99 → 2, 100–999 → 3, ..."""
    r = max(int(reuse_hint), 1)
    return 0 if r == 1 else int(math.log10(r)) + 1


@dataclasses.dataclass
class Plan:
    """A fully-materialized preprocessing decision for one matrix."""

    fingerprint: str
    reorder: str                      # name in REORDERINGS
    scheme: str                       # rowwise | fixed | variable |
    #                                   hierarchical | pallas
    reuse_hint: int
    max_cluster: int = 8
    workload: str = "a2"              # a2 | spmm | chain | batch — the
    #                                   kernel family planned for (batch:
    #                                   a block-diagonal pack of requests)
    perm: np.ndarray | None = None        # new row -> old row (None: identity)
    boundaries: np.ndarray | None = None  # cluster starts (None: rowwise)
    preprocess_s: float = 0.0             # wall time spent materializing
    predicted: dict = dataclasses.field(default_factory=dict)
    measured: dict = dataclasses.field(default_factory=dict)
    from_cache: bool = False
    version: str = PLAN_CACHE_VERSION

    @property
    def is_identity(self) -> bool:
        return self.reorder == "original" and self.scheme == "rowwise"

    @property
    def key(self) -> str:
        return PlanCache.key(self.fingerprint, self.reuse_hint,
                             self.workload)

    def nbytes(self) -> int:
        """Approximate in-memory footprint (the cache's budget unit)."""
        n = 512          # metadata floor
        if self.perm is not None:
            n += self.perm.nbytes
        if self.boundaries is not None:
            n += self.boundaries.nbytes
        return n

    # -- (de)serialization ---------------------------------------------------

    @staticmethod
    def _payload_digest(meta_bytes: bytes, perm, boundaries) -> str:
        """blake2b over everything that round-trips: a flipped bit or a
        truncated array anywhere in the entry changes this digest."""
        d = hashlib.blake2b(digest_size=16)
        d.update(meta_bytes)
        for tag, arr in ((b"perm", perm), (b"boundaries", boundaries)):
            if arr is not None:
                d.update(tag)
                d.update(np.ascontiguousarray(arr,
                                              dtype=np.int64).tobytes())
        return d.hexdigest()

    def to_npz_bytes(self) -> bytes:
        meta = {
            "fingerprint": self.fingerprint, "reorder": self.reorder,
            "scheme": self.scheme, "reuse_hint": self.reuse_hint,
            "max_cluster": self.max_cluster, "workload": self.workload,
            "preprocess_s": self.preprocess_s, "predicted": self.predicted,
            "measured": self.measured, "version": self.version,
        }
        meta_bytes = json.dumps(meta).encode()
        arrays = {"meta": np.frombuffer(meta_bytes, dtype=np.uint8)}
        if self.perm is not None:
            arrays["perm"] = np.asarray(self.perm, dtype=np.int64)
        if self.boundaries is not None:
            arrays["boundaries"] = np.asarray(self.boundaries, dtype=np.int64)
        digest = self._payload_digest(meta_bytes, arrays.get("perm"),
                                      arrays.get("boundaries"))
        arrays["checksum"] = np.frombuffer(digest.encode(), dtype=np.uint8)
        buf = io.BytesIO()
        np.savez(buf, **arrays)
        return buf.getvalue()

    @classmethod
    def from_npz_bytes(cls, raw: bytes, path: str = "<bytes>") -> "Plan":
        """Deserialize one entry; any damage — an unreadable archive, a
        missing member, a checksum mismatch — raises
        :class:`~repro_torch.resilience.errors.CorruptPlanError` (which the
        cache turns into miss-plus-evict, never an exception to the
        serving path)."""
        try:
            with np.load(io.BytesIO(raw)) as z:
                if "meta" not in z.files:
                    raise CorruptPlanError(path, "missing meta member")
                meta_bytes = bytes(z["meta"].tobytes())
                meta = json.loads(meta_bytes.decode())
                perm = np.array(z["perm"]) if "perm" in z.files else None
                bounds = (np.array(z["boundaries"])
                          if "boundaries" in z.files else None)
                stored = (bytes(z["checksum"].tobytes()).decode()
                          if "checksum" in z.files else None)
        except CorruptPlanError:
            raise
        except Exception as e:   # BadZipFile / ValueError / json / key
            raise CorruptPlanError(
                path, f"unreadable archive ({type(e).__name__}: {e})")
        if stored is None:
            raise CorruptPlanError(path, "missing checksum member")
        expect = cls._payload_digest(meta_bytes, perm, bounds)
        if stored != expect:
            raise CorruptPlanError(
                path, f"checksum mismatch (stored {stored[:8]}…, "
                f"payload {expect[:8]}…)")
        return cls(fingerprint=meta["fingerprint"], reorder=meta["reorder"],
                   scheme=meta["scheme"], reuse_hint=meta["reuse_hint"],
                   max_cluster=meta["max_cluster"],
                   workload=meta.get("workload", "a2"), perm=perm,
                   boundaries=bounds, preprocess_s=meta["preprocess_s"],
                   predicted=meta["predicted"], measured=meta["measured"],
                   version=meta["version"])


class PlanCache:
    """LRU in-memory + optional on-disk plan store with hit/miss accounting
    and a joint byte budget (``max_bytes=None`` disables eviction).

    The budget covers files inherited from previous processes too: at
    construction the directory is scanned and pre-existing ``.npz`` files
    count as the coldest tier (evicted oldest-mtime-first before any live
    entry), so a periodically-restarted server cannot grow the store by
    ~budget per restart.

    Thread-safe: one re-entrant lock guards the LRU, the byte accounting
    and the counters, so the serving front-end's worker threads can share
    a cache."""

    def __init__(self, path: str | None = None,
                 max_bytes: int | None = None,
                 namespace: str = ""):
        self.path = path
        self.max_bytes = max_bytes
        # '_' is the on-disk filename separator ('|' is rewritten to it):
        # a namespace containing it would make 'ns-a_x' files match
        # namespace 'a''s scan prefix 'ns-a_' — cross-tenant eviction
        if namespace and not all(c.isalnum() or c == "-"
                                 for c in namespace):
            raise ValueError("namespace must be alphanumeric/dash "
                             f"(got {namespace!r})")
        self.namespace = namespace
        self._mem: OrderedDict[str, Plan] = OrderedDict()
        self._bytes: dict[str, int] = {}
        # pre-existing on-disk files (path → size), oldest mtime first —
        # they count against the budget and are the first evicted
        self._inherited: OrderedDict[str, int] = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.corrupt_evictions = 0    # damaged disk entries deleted
        self._lock = threading.RLock()
        self._scan_disk()
        self._enforce_budget()

    @staticmethod
    def _note_corrupt(reason: str) -> None:
        # lazy import: metrics pulls in heavier modules; the cache must
        # stay importable early in the stack
        from repro_torch.obs import metrics as obs_metrics
        obs_metrics.get_registry().counter("plan_cache_corrupt",
                                           reason=reason).inc()

    def _evict_corrupt(self, path: str, reason: str) -> None:
        """Miss-plus-evict: delete a damaged disk entry and account it.
        The serving path never sees the damage — just a cache miss."""
        self.corrupt_evictions += 1
        self._inherited.pop(path, None)
        try:
            os.remove(path)
        except OSError:
            pass
        self._note_corrupt(reason)

    def _scan_disk(self) -> None:
        """Account the pre-existing on-disk tier: a restarted process
        inherits the directory, so its files count against the budget
        (oldest-mtime-first — mtime is the disk tier's LRU proxy).
        Without this, each process would only ever evict its own writes
        and the store would grow by ~budget per restart."""
        if self.path is None or self.max_bytes is None \
                or not os.path.isdir(self.path):
            return
        files = []
        prefix = f"ns-{self.namespace}_" if self.namespace else None

        def _mine(name: str) -> bool:
            # budget isolation: only this namespace's files are accounted
            # (and thus evictable/cleanable) by this cache instance
            if prefix is not None:
                return name.startswith(prefix)
            return not name.startswith("ns-")

        for name in os.listdir(self.path):
            p = os.path.join(self.path, name)
            if name.endswith(".tmp"):
                # crash debris from an interrupted atomic write
                if _mine(name):
                    self._evict_corrupt(p, "stale_tmp")
                continue
            if not name.endswith(".npz") or not _mine(name):
                continue
            try:
                st = os.stat(p)
                with open(p, "rb") as fh:
                    magic = fh.read(4)
            except OSError:
                self._evict_corrupt(p, "unreadable")
                continue
            if magic != b"PK\x03\x04":       # not a zip/npz at all
                self._evict_corrupt(p, "not_npz")
                continue
            files.append((st.st_mtime, st.st_size, p))
        for _, size, p in sorted(files):
            self._inherited[p] = size

    @staticmethod
    def key(fingerprint: str, reuse_hint: int, workload: str = "a2",
            namespace: str = "") -> str:
        base = (f"{fingerprint}|r{reuse_bucket(reuse_hint)}|{workload}"
                f"|{PLAN_CACHE_VERSION}")
        return f"ns-{namespace}|{base}" if namespace else base

    def _key(self, fingerprint: str, reuse_hint: int,
             workload: str = "a2") -> str:
        return self.key(fingerprint, reuse_hint, workload, self.namespace)

    def _file(self, key: str) -> str | None:
        if self.path is None:
            return None
        return os.path.join(self.path, key.replace("|", "_") + ".npz")

    def get(self, fingerprint: str, reuse_hint: int,
            workload: str = "a2") -> Plan | None:
        with self._lock:
            return self._get_locked(fingerprint, reuse_hint, workload)

    def _get_locked(self, fingerprint: str, reuse_hint: int,
                    workload: str) -> Plan | None:
        key = self._key(fingerprint, reuse_hint, workload)
        plan = self._mem.get(key)
        if plan is None:
            f = self._file(key)
            if f is not None and os.path.exists(f):
                try:
                    with open(f, "rb") as fh:
                        raw = fh.read()
                    raw = _faults.corrupt_bytes("cache_load", raw)
                    plan = Plan.from_npz_bytes(raw, path=f)
                except (CorruptPlanError, OSError) as e:
                    # miss-plus-evict: damage never reaches the caller
                    self._evict_corrupt(
                        f, e.reason if isinstance(e, CorruptPlanError)
                        else "io_error")
                    plan = None
                else:
                    if plan.version != PLAN_CACHE_VERSION:
                        # stale generation: evict so it stops costing a
                        # parse on every miss
                        self._evict_corrupt(f, "version_mismatch")
                        plan = None
                    else:
                        # now accounted as a live memory entry, not an
                        # inherited file (no double counting)
                        self._inherited.pop(f, None)
                        self._insert(key, plan)
        if plan is None:
            self.misses += 1
            return None
        self.hits += 1
        self._mem.move_to_end(key)               # refresh LRU recency
        hit = dataclasses.replace(plan, from_cache=True, preprocess_s=0.0)
        return hit

    def put(self, plan: Plan) -> None:
        with self._lock:
            self._put_locked(plan)

    def _put_locked(self, plan: Plan) -> None:
        key = self._key(plan.fingerprint, plan.reuse_hint, plan.workload)
        f = self._file(key)
        if f is not None:
            os.makedirs(self.path, exist_ok=True)
            # atomic publish: unique temp file in the same directory,
            # fsync'd, then os.replace — a crash at any point leaves
            # either the old entry or the new one under the live name,
            # never a truncated archive (the .tmp debris is swept by the
            # next _scan_disk)
            fd, tmp = tempfile.mkstemp(
                prefix=os.path.basename(f) + ".", suffix=".tmp",
                dir=self.path)
            try:
                with os.fdopen(fd, "wb") as fh:
                    fh.write(plan.to_npz_bytes())
                    fh.flush()
                    os.fsync(fh.fileno())
                os.replace(tmp, f)
            except BaseException:
                try:
                    os.remove(tmp)
                except OSError:
                    pass
                raise
            self._inherited.pop(f, None)    # overwritten: counted via _mem
        self._insert(key, dataclasses.replace(plan, from_cache=False))

    # -- LRU budget ----------------------------------------------------------

    def _insert(self, key: str, plan: Plan) -> None:
        self._mem[key] = plan
        self._mem.move_to_end(key)
        self._bytes[key] = plan.nbytes()
        self._enforce_budget()

    def _enforce_budget(self) -> None:
        if self.max_bytes is None:
            return
        # inherited disk files are the coldest tier: evicted first
        while self._inherited and self.total_bytes > self.max_bytes:
            path, _ = self._inherited.popitem(last=False)
            self.evictions += 1
            try:
                os.remove(path)
            except OSError:
                pass
        while self.total_bytes > self.max_bytes and len(self._mem) > 1:
            key, _ = self._mem.popitem(last=False)       # LRU out
            self._bytes.pop(key, None)
            self.evictions += 1
            f = self._file(key)
            if f is not None and os.path.exists(f):
                os.remove(f)                # the disk tier is budgeted too

    @property
    def total_bytes(self) -> int:
        with self._lock:
            return (sum(self._bytes.values())
                    + sum(self._inherited.values()))

    def clear_memory(self) -> None:
        """Drop the in-memory layer (keeps disk) — used by tests to force
        an on-disk round-trip."""
        with self._lock:
            self._mem.clear()
            self._bytes.clear()

    @property
    def stats(self) -> dict:
        with self._lock:
            return {"hits": self.hits, "misses": self.misses,
                    "entries": len(self._mem), "bytes": self.total_bytes,
                    "evictions": self.evictions,
                    "corrupt_evictions": self.corrupt_evictions,
                    "namespace": self.namespace}
