"""The closed loop: ``clients`` callers, each with one request outstanding
through the coalescer, the next sent the moment its answer comes.

The callers are not threads. A caller of ``CoalescingSearchExecutor.search``
enqueues its request and blocks on the request's future. Hundreds of
blocked threads would take the interpreter lock from the dispatcher and the
finalize thread every time a batch of them wakes (the harness's own threads
would pace the run), so here one harness thread stands for every caller:
the future's callback, run by the thread that answers it, only reads the
clock and hands the answer over; the harness thread records it and sends
the caller's next request. ``submit`` is the enqueue of ``search`` without
the wait: the same item on the same queue, under the same lock, and
``check_mirror`` refuses a program whose ``search`` says otherwise.

Answers are kept in preallocated numpy blocks and not as Python objects: a
run keeps hundreds of thousands of answers, and as objects the collector
would walk them all at each full collection, pausing the served threads
for most of a second each time.
"""

from __future__ import annotations

import ast
import functools
import inspect
import itertools
import queue
import textwrap
import threading
import time
from concurrent.futures import Future

import numpy as np

BLOCK = 1 << 16


def submit(ex, text: str, emb, k: int, now) -> Future:
    """``ex.search(text, emb, k, now)`` without waiting for its answer."""
    future: Future = Future()
    with ex._submit_lock:
        if ex._closed:
            raise RuntimeError("executor is closed")
        ex._queue.put(((text, emb, k), now, future))
    return future


def _search_as_mirrored(self, query, query_embedding, top_k, now=None):
    future: Future = Future()
    with self._submit_lock:
        if self._closed:
            raise RuntimeError("executor is closed")
        self._queue.put(((query, query_embedding, top_k), now, future))
    return future.result()


def _body(fn) -> str:
    """The function's statements, docstring left out, as a syntax tree."""
    body = ast.parse(textwrap.dedent(inspect.getsource(fn))).body[0].body
    if body and isinstance(body[0], ast.Expr) and isinstance(body[0].value, ast.Constant):
        body = body[1:]
    return ast.dump(ast.Module(body=body, type_ignores=[]))


def check_mirror(executor_type) -> None:
    """Raise unless ``executor_type.search`` is the enqueue that ``submit``
    makes followed by the wait for the future: what the window drives has
    to be what a caller of ``search`` gets."""
    if _body(executor_type.search) != _body(_search_as_mirrored):
        raise RuntimeError(f"{executor_type.__qualname__}.search is no longer the enqueue "
                           "that recall_bench/load.py submit mirrors")


class Answers:
    """Every answer: pool index, sent and answered (host clock), the hit
    count, and the hits' rows and scores (up to ``k``); failures by entry."""

    def __init__(self, k: int):
        self.k = k
        self._count = itertools.count()
        self._blocks: list = []
        self.errors: dict = {}
        self.n = 0

    def add(self, q: int, sent: float, done: float, rows, scores, err) -> None:
        i = next(self._count)
        b, o = divmod(i, BLOCK)
        while len(self._blocks) <= b:
            self._blocks.append({
                "q": np.empty(BLOCK, np.int64), "sent": np.empty(BLOCK),
                "done": np.empty(BLOCK), "hits": np.empty(BLOCK, np.int64),
                "rows": np.empty((BLOCK, self.k + 1), np.int64),
                "scores": np.empty((BLOCK, self.k + 1))})
        blk = self._blocks[b]
        blk["q"][o], blk["sent"][o], blk["done"][o] = q, sent, done
        if err is not None:
            self.errors[i] = err
            blk["hits"][o] = -1
        else:
            m = min(len(rows), self.k + 1)   # one past k: an answer too long shows
            blk["hits"][o] = len(rows)
            blk["rows"][o, :m] = rows[:m]
            blk["scores"][o, :m] = scores[:m]
        self.n = i + 1

    def columns(self) -> dict:
        """Every field over every answer, as whole arrays."""
        n = self.n
        return {key: np.concatenate([blk[key] for blk in self._blocks])[:n]
                for key in ("q", "sent", "done", "hits", "rows", "scores")} if n else {}


class ClosedLoop:
    """Caller c sends pool requests c, c + clients, c + 2·clients, ... (mod
    the pool) one after another. ``answers`` holds every answer, as
    ``answer(hits)`` reads it; ``pending`` the request each caller still
    waits for. ``callback_s`` is the time the answering threads spent in
    the harness's callbacks, ``harness_s`` the harness thread's time
    recording answers and sending requests."""

    def __init__(self, ex, pool: list, clients: int, now, answer, k: int):
        check_mirror(type(ex))
        self.ex, self.pool, self.clients, self.now = ex, pool, clients, now
        self.answer = answer
        self.answers = Answers(k)
        self.pending: dict = {}
        self.callback_s = 0.0
        self.harness_s = 0.0
        self._answered: queue.SimpleQueue = queue.SimpleQueue()
        self._stopping = False
        self._idle = threading.Condition()
        self._thread = threading.Thread(target=self._serve, daemon=True, name="bench-callers")

    def start(self) -> None:
        for c in range(self.clients):
            self._send(c, c)
        self._thread.start()

    def _send(self, c: int, j: int) -> None:
        q = j % len(self.pool)
        text, emb, k = self.pool[q]
        t = time.perf_counter()
        self.pending[c] = (q, t)
        try:
            fut = submit(self.ex, text, emb, k, self.now)
        except RuntimeError as exc:
            self._answered.put((c, j, q, t, time.perf_counter(), repr(exc)))
            return
        fut.add_done_callback(functools.partial(self._done, c, j, q, t))

    def _done(self, c: int, j: int, q: int, t: float, f: Future) -> None:
        done = time.perf_counter()
        self._answered.put((c, j, q, t, done, f))
        self.callback_s += time.perf_counter() - done

    def _serve(self) -> None:
        while True:
            item = self._answered.get()
            if item is None:
                return
            a = time.perf_counter()
            c, j, q, t, done, f = item
            if isinstance(f, str):
                ans, err, resend = None, f, False
            else:
                exc = f.exception()
                ans, err, resend = (None, repr(exc), True) if exc else (self.answer(f.result()),
                                                                        None, True)
            rows, scores = ans if ans is not None else ((), ())
            self.answers.add(q, t, done, rows, scores, err)
            with self._idle:
                del self.pending[c]
                if resend and not self._stopping:
                    self._send(c, j + self.clients)
                else:
                    self._idle.notify_all()
            self.harness_s += time.perf_counter() - a

    def stop(self, timeout: float) -> None:
        """Send nothing more, wait at most ``timeout`` s for the answers
        still due, and end the harness thread."""
        deadline = time.perf_counter() + timeout
        with self._idle:
            self._stopping = True
            while self.pending and time.perf_counter() < deadline:
                self._idle.wait(timeout=max(0.0, deadline - time.perf_counter()))
        self._answered.put(None)
        self._thread.join()
