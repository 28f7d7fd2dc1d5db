"""Spans of the served search path, recorded in the program (off by default).

``enable(capacity)`` starts a recorder and ``disable()`` drops it. While it
is off, every span site costs one check of a module flag and hands back the
shared ``NOOP`` span: nothing is allocated and no collector callback is
installed. While it is on, each span is one row of preallocated NumPy
columns (``records()``); no Python object outlives its span, so the
recorder adds nothing for the interpreter's collector to walk. Rows past
``capacity`` are counted in ``dropped``, never lost unseen.

A row holds the span's name (an index into ``NAMES``), its thread, its batch
number, its parent (the row of the span that enclosed it on the same
thread, or -1), ``start`` and ``end`` on ``time.perf_counter()`` (``end`` is
NaN while the span is open), the thread's CPU seconds over it
(``time.thread_time()``) and up to ``N_ATTRS`` integers whose meaning is
fixed per name (``ATTRS``). ``perf_counter`` is the host clock a
``torch.profiler`` trace can be tied to through ``cudaStreamQuery`` calls
timed on it, so the rows can be laid over the device's timeline.

A span's batch is given where a batch starts (``new_batch``: the coalescer
at collection, ``RecallEngine.search_batch``) and inherited from the
enclosing span, else from the thread's current batch; the finalize, on
another thread, takes its dispatch's number from the batch context.

Per-name totals (count, wall seconds, thread CPU seconds) are kept besides
the rows, per thread, and go on counting past ``capacity``: ``totals()``,
exported by the server's ``/metrics``. ``enable(0)`` keeps the totals alone
(no rows, nothing dropped): the server's mode, whose operator switch is
``Engine:Tracing`` (``OMNI__Engine__Tracing=true``). The rows are read by
``tools/span_report.py``, which serves a closed loop and breaks the host's
time down by span, batch and thread.

No span takes a lock: rows are claimed from an ``itertools.count`` (one C
call), and a thread's stack and totals are written by that thread alone,
where a collector pass (whose callback opens and closes one span) may
interrupt but leaves them as it found them. A thread's totals and drops are
folded into the recorder's shared ones when the thread ends (the server
runs a thread a request), under the one lock that ``totals()`` takes.
"""

from __future__ import annotations

import gc
import itertools
import threading
import time
import weakref

import numpy as np

NAMES = (
    "coalesce.collect",        # dispatcher: first item received -> batch closed
    "coalesce.inflight_wait",  # dispatcher: waiting for a pipeline slot
    "coalesce.finalize_queue", # dispatched batch waiting for the finalize worker
    "coalesce.resolve",        # finalize worker: set_result (callers' callbacks)
    "engine.dispatch",         # RecallEngine._dispatch_device_batch
    "dispatch.prep",           # query rows, norms, query terms, keyword weights
    #                            (and an attached device embedder's forward)
    "dispatch.upload",         # host -> card copies, normalization on the card
    "dispatch.launch",         # scans, selection, K2, the host copies' starts
    "engine.finalize",         # RecallEngine._finalize_device_batch
    "finalize.wait",           # the host blocked on the card's results
    "finalize.rescore",        # exact rescore: cosines, keyword, recency
    "finalize.certify",        # the certificates and the answers' hit lists
    "finalize.rescue",         # the wide rescue and the rescan loop
    "finalize.host_scan",      # the exact host scan of a query
    "scan.k1",                 # ops/scorer.py block_topt_int8_coarse
    "scan.xla",                # ops/xla_scorer.py score_topm
    "runtime.gc",              # one pass of the interpreter's collector
)
(COLLECT, INFLIGHT_WAIT, FINALIZE_QUEUE, RESOLVE, DISPATCH, PREP, UPLOAD, LAUNCH, FINALIZE,
 WAIT, RESCORE, CERTIFY, RESCUE, HOST_SCAN, SCAN_K1, SCAN_XLA, GC) = range(len(NAMES))

N_ATTRS = 6
ATTRS = {
    "coalesce.collect": ("fill", "max_batch", "backlog"),
    "engine.dispatch": ("b", "host_only", "device_embedded"),
    "engine.finalize": ("escalation_rounds", "host_fallbacks", "dd_escalations",
                        "rescue_wide", "rescue_sliced", "rescore_pairs"),
    "scan.k1": ("n", "d", "b", "sub", "t", "qt"),
    "scan.xla": ("n", "d", "b", "w"),
    "runtime.gc": ("generation", "collected"),
}
DEFAULT_CAPACITY = 1 << 20


class _Off:
    """The span every site gets while the recorder is off."""

    __slots__ = ()
    batch = -1

    def __enter__(self):
        return self

    def __exit__(self, et, ev, tb):
        return False

    def __bool__(self):
        return False

    def set(self, a=0, b=0, c=0, d=0, e=0, f=0):
        pass

    def step(self, name):
        pass


NOOP = _Off()
_rec = None   # the Recorder while tracing is on


class _Acc:
    """Span totals by name and spans dropped: one thread's, or those of the
    threads that have ended."""

    __slots__ = ("totals", "dropped")

    def __init__(self):
        self.totals = [[0, 0.0, 0.0] for _ in NAMES]
        self.dropped = 0

    def add(self, other: "_Acc") -> None:
        for t, o in zip(self.totals, other.totals):
            t[0] += o[0]
            t[1] += o[1]
            t[2] += o[2]
        self.dropped += other.dropped


class _Thread:
    """One thread's open spans, current batch and totals; written by that
    thread alone, held by its thread-local slot (so it dies with the
    thread) and by its open spans."""

    __slots__ = ("ident", "name", "stack", "batch", "acc", "__weakref__")

    def __init__(self):
        t = threading.current_thread()
        self.ident, self.name = t.ident, t.name
        self.stack: list = []
        self.batch = -1
        self.acc = _Acc()


class _Span:
    __slots__ = ("rec", "th", "row", "name", "batch", "t0", "c0", "_step")

    def __enter__(self):
        return self

    def __exit__(self, et, ev, tb):
        self.rec.close(self)
        return False

    def __bool__(self):
        return True

    def set(self, a=0, b=0, c=0, d=0, e=0, f=0):
        """The span's integer attributes (``ATTRS``)."""
        if self.row < self.rec.capacity:
            self.rec.attrs[self.row] = (a, b, c, d, e, f)

    def step(self, name: int) -> None:
        """Close the span's current step, if any, and open the child
        ``name``: consecutive parts of one span without nested blocks."""
        if self._step is not None:
            self.rec.close(self._step)
        self._step = self.rec.open(name, None)


class _Threads:
    """The threads' totals: each live thread's, and those of the threads that
    have ended, folded together when each thread's state dies. Apart from the
    recorder, so that a thread outliving it does not keep its rows alive."""

    def __init__(self, names: bool):
        self.lock = threading.Lock()
        self.keys = itertools.count()
        self.live: dict = {}       # key -> the live thread's _Acc
        self.ended = _Acc()
        self.names = {} if names else None   # thread id -> name

    def add(self, th: _Thread) -> None:
        key = next(self.keys)
        with self.lock:
            self.live[key] = th.acc
            if self.names is not None:
                self.names[th.ident] = th.name
        weakref.finalize(th, self.fold, key).atexit = False

    def fold(self, key) -> None:
        with self.lock:
            self.ended.add(self.live.pop(key))

    def sum(self) -> _Acc:
        """Every thread's totals and drops, summed under the lock: no thread
        counted twice or missed while it ends."""
        out = _Acc()
        with self.lock:
            for acc in (self.ended, *self.live.values()):
                out.add(acc)
        return out


class Recorder:
    def __init__(self, capacity: int):
        self.capacity = capacity
        self.name = np.full(capacity, -1, np.int16)
        self.thread = np.zeros(capacity, np.int64)
        self.batch = np.full(capacity, -1, np.int64)
        self.parent = np.full(capacity, -1, np.int64)
        self.start = np.zeros(capacity)
        self.end = np.full(capacity, np.nan)
        self.cpu = np.zeros(capacity)
        self.attrs = np.zeros((capacity, N_ATTRS), np.int64)
        self._rows = itertools.count()
        self._batches = itertools.count()
        self._local = threading.local()
        self.threads = _Threads(names=capacity > 0)
        self._gc_span = None

    def thread_state(self) -> _Thread:
        th = getattr(self._local, "th", None)
        if th is None:
            th = self._local.th = _Thread()
            self.threads.add(th)
        return th

    def open(self, name: int, batch, start: float | None = None) -> _Span:
        th = self.thread_state()
        sp = _Span()
        sp.rec, sp.th, sp.name, sp._step = self, th, name, None
        parent = th.stack[-1] if th.stack else None
        if batch is None:
            batch = parent.batch if parent is not None else th.batch
        sp.batch = batch
        sp.row = row = next(self._rows)
        sp.c0 = time.thread_time()
        sp.t0 = time.perf_counter() if start is None else start
        if row < self.capacity:
            self.thread[row] = th.ident
            self.batch[row] = batch
            self.parent[row] = parent.row if parent is not None else -1
            self.start[row] = sp.t0
            self.name[row] = name
        elif self.capacity:
            th.acc.dropped += 1
        th.stack.append(sp)
        return sp

    def close(self, sp: _Span, cpu: float | None = None) -> None:
        if sp._step is not None:
            self.close(sp._step)
            sp._step = None
        t1 = time.perf_counter()
        if cpu is None:
            cpu = time.thread_time() - sp.c0
        stack = sp.th.stack
        if stack and stack[-1] is sp:
            stack.pop()
        elif sp in stack:
            # children left open by an exception end with their parent
            del stack[stack.index(sp):]
        if sp.row < self.capacity:
            self.end[sp.row] = t1
            self.cpu[sp.row] = cpu
        tot = sp.th.acc.totals[sp.name]
        tot[0] += 1
        tot[1] += t1 - sp.t0
        tot[2] += cpu

    def on_gc(self, phase: str, info: dict) -> None:
        if phase == "start":
            self._gc_span = self.open(GC, -1)
        elif self._gc_span is not None:
            sp, self._gc_span = self._gc_span, None
            sp.set(info.get("generation", -1), info.get("collected", 0))
            self.close(sp)


def enable(capacity: int = DEFAULT_CAPACITY) -> None:
    """Start recording into a fresh buffer of ``capacity`` spans (a running
    recorder's spans are dropped), with the collector's passes; 0 keeps the
    totals alone."""
    global _rec
    disable()
    rec = Recorder(capacity)
    gc.callbacks.append(rec.on_gc)
    _rec = rec


def disable() -> None:
    """Stop recording and drop what was recorded."""
    global _rec
    rec, _rec = _rec, None
    if rec is not None and rec.on_gc in gc.callbacks:
        gc.callbacks.remove(rec.on_gc)


def enabled() -> bool:
    return _rec is not None


def span(name: int, batch: int | None = None):
    """A context manager over one span of ``name`` (``NAMES``). ``batch``
    defaults to the enclosing span's, else the thread's current batch."""
    rec = _rec
    if rec is None:
        return NOOP
    return rec.open(name, batch)


def add(name: int, start: float, batch: int | None = None) -> None:
    """A span of ``name`` from ``start`` (an earlier ``perf_counter``
    reading, maybe another thread's) to now, with no CPU time."""
    rec = _rec
    if rec is not None:
        rec.close(rec.open(name, batch, start), cpu=0.0)


def new_batch() -> int:
    """The next batch number, now the calling thread's current batch; -1
    while off."""
    rec = _rec
    if rec is None:
        return -1
    th = rec.thread_state()
    th.batch = next(rec._batches)
    return th.batch


def records() -> dict:
    """The recorded spans as columns, in the order they opened (empty while
    off): ``name`` (into ``names``), ``thread``, ``batch``, ``parent`` (a
    row, -1 at the root), ``start``, ``end`` (NaN while open), ``cpu``,
    ``attrs`` (a row whose ``name`` reads -1 is still being written by its
    thread); ``threads`` maps each thread's id to its name; ``dropped``
    counts the spans past the capacity."""
    rec = _rec
    if rec is None:
        return {}
    written = np.flatnonzero(rec.name >= 0)
    n = int(written[-1]) + 1 if written.size else 0
    out = {k: getattr(rec, k)[:n].copy()
           for k in ("name", "thread", "batch", "parent", "start", "end", "cpu", "attrs")}
    out["names"] = NAMES
    with rec.threads.lock:
        out["threads"] = dict(rec.threads.names or {})
    out["dropped"] = dropped()
    return out


def dropped() -> int:
    """Spans opened past the capacity since ``enable`` (0 while off, and
    with no rows kept)."""
    rec = _rec
    return rec.threads.sum().dropped if rec is not None else 0


def totals() -> dict:
    """{name: (count, wall seconds, thread CPU seconds)} of every span closed
    since ``enable``, past the capacity too; empty while off."""
    rec = _rec
    if rec is None:
        return {}
    return {NAMES[i]: tuple(t) for i, t in enumerate(rec.threads.sum().totals) if t[0]}
