"""Request-coalescing search executor.

The device scan cost is per-batch, not per-query (one kernel launch scans
the whole index for every query in the batch), so a serving process should
batch concurrent searches. This executor collects requests arriving within
a small window (or until the batch fills) on a dispatcher thread and runs
them through ``engine.search_batch`` in one device pass; callers block on a
future. Single-request latency cost is bounded by the window (default 2 ms);
under load, throughput approaches the batched-scan ceiling (bench.py).

The reference has no equivalent (single-process, per-request scoring); this
is the "async request-coalescing server loop" called for by SURVEY.md §7.

Batches PIPELINE through the engine's dispatch/finalize split
(search/engine.py): the dispatcher thread dispatches a batch's device scans
and immediately returns to collecting the next batch, while a single
finalize worker completes the host rescore and resolves the futures. Under
load, batch i's host rescore overlaps batch i+1's coalescing window and
device scan; a small in-flight bound keeps a host-rescore backlog from
queueing unbounded device work.

With tracing on (utils/tracing.py) each batch records ``coalesce.collect``
(fill, max_batch and the backlog left queued when it closed),
``coalesce.inflight_wait`` (the dispatcher waiting for a pipeline slot),
``coalesce.finalize_queue`` (the dispatched batch waiting for the finalize
worker, from its submission) and ``coalesce.resolve`` (the callers'
futures and callbacks), under one batch number with the engine's spans.
The engine counts the searches (``RecallEngine.stats``).
"""

from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from datetime import datetime, timezone

from omni_recall_tpu_torch.utils import tracing


class CoalescingSearchExecutor:
    def __init__(
        self,
        engine,
        max_batch: int = 128,
        window_ms: float = 2.0,
        pipeline_depth: int = 2,
    ) -> None:
        self.engine = engine
        self.max_batch = max_batch
        self.window_s = window_ms / 1000.0
        self._queue: queue.Queue = queue.Queue()
        self._closed = False
        # guards the closed-flag check + enqueue as one atomic step: without
        # it a search() could pass the check, lose the CPU, and enqueue
        # AFTER close()'s sentinel — its future would never resolve and the
        # caller would block forever
        self._submit_lock = threading.Lock()
        self._finalize_pool = ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="search-finalize"
        )
        self._inflight = threading.Semaphore(max(1, pipeline_depth))
        self._thread = threading.Thread(target=self._run, daemon=True, name="search-coalescer")
        self._thread.start()

    def search(
        self,
        query: str,
        query_embedding: list[float] | None,
        top_k: int,
        now: datetime | None = None,
    ):
        """Blocking search; batched transparently with concurrent callers."""
        future: Future = Future()
        with self._submit_lock:
            if self._closed:
                raise RuntimeError("executor is closed")
            self._queue.put(((query, query_embedding, top_k), now, future))
        return future.result()

    def close(self) -> None:
        with self._submit_lock:
            if self._closed:
                return
            self._closed = True
            self._queue.put(None)
        self._thread.join(timeout=5)
        # drain in-flight finalizes so every accepted future resolves
        self._finalize_pool.shutdown(wait=True)

    # -- dispatcher --

    def _run(self) -> None:
        while True:
            item = self._queue.get()
            if item is None:
                return
            batch = [item]
            closing = False
            with tracing.span(tracing.COLLECT, tracing.new_batch()) as sp:
                deadline = time.monotonic() + self.window_s
                while len(batch) < self.max_batch:
                    try:
                        nxt = self._queue.get(timeout=max(0.0, deadline - time.monotonic()))
                    except queue.Empty:
                        break
                    if nxt is None:
                        closing = True
                        break
                    batch.append(nxt)
                if sp:
                    sp.set(len(batch), self.max_batch, self._queue.qsize())
            self._flush(batch)
            if closing:
                return

    def _flush(self, batch) -> None:
        # Partition by explicit 'now': recency scores depend on it, so one
        # caller's pinned timestamp must never skew unrelated coalesced
        # queries. Callers without a 'now' share a single device pass (the
        # common serving case); each distinct explicit 'now' gets its own.
        groups: dict[object, list] = {}
        for item in batch:
            groups.setdefault(item[1], []).append(item)
        for gi, (now, group) in enumerate(groups.items()):
            if gi:
                tracing.new_batch()  # one batch number a device pass
            requests = [req for req, _, _ in group]
            eng = self.engine
            if eng.options.backend == "oracle" or eng.device_index is None:
                # no device stage to pipeline: run synchronously
                try:
                    results = eng.search_batch(requests, now=now)
                    if len(results) != len(group):
                        raise RuntimeError(
                            f"search_batch returned {len(results)} results "
                            f"for {len(group)} requests"
                        )
                except Exception as exc:
                    for _, _, future in group:
                        future.set_exception(exc)
                    continue
                for (_, _, future), hits in zip(group, results):
                    future.set_result(hits)
                continue
            # pipelined path: dispatch here (device scans queue
            # asynchronously), finalize on the worker. The semaphore bounds
            # dispatched-but-unfinalized batches; acquiring it BEFORE the
            # dispatch applies backpressure to the dispatcher, not callers.
            with tracing.span(tracing.INFLIGHT_WAIT):
                self._inflight.acquire()
            try:
                ctx = eng._dispatch_device_batch(
                    requests, eng.options.recent_window,
                    now or datetime.now(timezone.utc),
                )
            except Exception as exc:
                self._inflight.release()
                for _, _, future in group:
                    future.set_exception(exc)
                continue
            ctx["submitted"] = time.perf_counter()
            try:
                self._finalize_pool.submit(self._finalize_group, ctx, group)
            except RuntimeError:
                # close() joined past its timeout while this thread was
                # blocked on the in-flight semaphore and already shut the
                # pool down: finalize inline so the accepted futures still
                # resolve (an escaping exception here would kill the only
                # dispatcher thread with callers blocked forever)
                self._finalize_group(ctx, group)

    def _finalize_group(self, ctx, group) -> None:
        # every future resolves exactly once; an exception must never
        # escape (it would silently kill the finalize worker's task while
        # callers block forever)
        batch = ctx.get("batch")
        try:
            tracing.add(tracing.FINALIZE_QUEUE, ctx["submitted"], batch)
            results = self.engine._finalize_device_batch(ctx)
            if len(results) != len(group):
                raise RuntimeError(
                    f"finalize returned {len(results)} results for "
                    f"{len(group)} requests"
                )
        except Exception as exc:
            for _, _, future in group:
                future.set_exception(exc)
            return
        finally:
            self._inflight.release()
        with tracing.span(tracing.RESOLVE, batch):
            for (_, _, future), hits in zip(group, results):
                future.set_result(hits)
