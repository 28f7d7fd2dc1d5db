"""Continuous-batching scheduler for the local decoder (PyTorch port of
omni_recall_tpu/chat/serving.py).

Iteration-level scheduling over S persistent decode slots (vLLM/Orca):

- the serving state (models/decoder.py ``SlotState``: the KV cache
  [S, max_len, ...], per-slot positions, done flags, sampling keys and
  next-token logits) lives on the card and is updated in place,
- **join**: a new request prefills at its own prompt bucket (batch 1) and is
  spliced into a free slot (``decoder.insert_slot``),
- **decode** runs in chunks of T steps (``decoder.decode_chunk``), with one
  readback a chunk: the [S, T] token block. Positions are tracked on the
  host (they advance deterministically), so no state is ever read back,
- **leave**: EOS frees a slot at the next chunk boundary; the host truncates
  at the request's budget and retires the slot. Freed slots admit queued
  requests at once,
- the attention window of a chunk is the largest live position plus T,
  rounded up to 128 (the bound ``generate`` uses),
- per-slot sampling keys make temperature > 0 reproducible per request,
  whatever the batch's composition.

Isolation invariant: a slot's token stream is a pure function of its own
prompt and seed (attention is row-local, and ``generate`` decodes on the
same row count), so greedy streams are bit for bit ``decoder.generate``'s
at the same attend window.

Optional chunked prefill (``prefill_chunk`` > 0): admission advances one
``decoder.prefill_block`` a scheduler iteration (at most ``prefill_budget``
blocks an iteration across admissions, round-robin), interleaved with
decode chunks. Its cross-block attention reads the compute-dtype cache, so
the bit-equality with ``generate`` holds only for whole-prompt prefill.

An error in a chunk fails every in-flight request (the router's failover
turns that into the recall-only fallback upstream) and rebuilds the
serving state on the same device; the batcher never moves to the CPU.
"""

from __future__ import annotations

import logging
import threading
from dataclasses import dataclass, field

import torch

logger = logging.getLogger(__name__)


@dataclass
class _Request:
    toks: list[int]           # BOS + prompt bytes (already truncated)
    seed: int
    max_new: int
    event: threading.Event = field(default_factory=threading.Event)
    tokens: list[int] = field(default_factory=list)  # emitted (pre-EOS)
    err: Exception | None = None
    done: bool = False


class ContinuousBatcher:
    """S-slot continuous-batching decode loop over models/decoder.py.

    ``submit`` enqueues and wakes the scheduler thread; the scheduler admits
    requests into free slots (prefill + splice), runs T-step decode chunks
    while any slot is live, and retires slots on EOS or budget. All device
    work happens on the scheduler thread. ``weights``: the decoder's
    ``Weights`` (``decoder.serving_weights``) on the serving device."""

    def __init__(self, dec_module, weights, cfg, *, slots: int = 4, chunk: int = 16,
                 temperature: float = 0.0, prompt_buckets=(128, 256, 512),
                 prefill_chunk: int = 0, prefill_budget: int = 0) -> None:
        self._dec = dec_module
        self.params = weights
        self.cfg = cfg
        self.device = weights.device
        self.slots = int(slots)
        self.chunk = int(chunk)
        self.temperature = float(temperature)
        self._buckets = tuple(prompt_buckets)
        self.prefill_chunk = max(0, int(prefill_chunk))
        self.prefill_budget = max(0, int(prefill_budget))
        self._admissions: list[dict] = []   # in-progress chunked prefills
        self._adm_rr = 0                    # round-robin cursor (budgeted)
        self._reserved: set[int] = set()    # slots held by admissions
        self._cond = threading.Condition()
        self._pending: list[_Request] = []
        self._active: list[_Request | None] = [None] * self.slots
        self._host_pos = [0] * self.slots   # upper bound on the device position
        self._state = None                  # decoder.SlotState
        self._thread: threading.Thread | None = None
        self._stop = False
        self.chunks_run = 0                 # decode chunks since construction

    # -- public --

    def submit(self, toks: list[int], seed: int, max_new: int) -> _Request:
        req = _Request(toks=list(toks), seed=int(seed), max_new=int(max_new))
        with self._cond:
            if self._thread is None:
                self._thread = threading.Thread(target=self._loop, daemon=True,
                                                name="chat-continuous")
                self._thread.start()
            self._pending.append(req)
            self._cond.notify_all()
        return req

    def generate_sync(self, toks: list[int], seed: int, max_new: int) -> list[int]:
        req = self.submit(toks, seed, max_new)
        req.event.wait()
        if req.err is not None:
            raise req.err
        return req.tokens

    def shutdown(self) -> None:
        with self._cond:
            self._stop = True
            self._cond.notify_all()
        if self._thread is not None and self._thread is not threading.current_thread():
            self._thread.join(timeout=60)

    def bucket_for(self, n_tokens: int, max_new: int) -> int:
        return next((b for b in self._buckets
                     if b >= n_tokens and b + max_new <= self.cfg.max_len),
                    self.cfg.max_len - max_new)

    # -- scheduler internals (single thread; owns the device state) --

    def _init_state(self):
        return self._dec.SlotState(self.cfg, self.slots, self.device)

    def _admit(self, slot: int, req: _Request) -> None:
        dec, cfg = self._dec, self.cfg
        bucket = self.bucket_for(len(req.toks), req.max_new)
        prompt = dec.pad_left_batch([req.toks], bucket)
        logits0, pcache = dec.prefill(self.params, prompt, cfg)
        dec.insert_slot(self._state, pcache, logits0, prompt,
                        dec._enc.prng_key(req.seed), slot, cfg)
        self._active[slot] = req
        self._host_pos[slot] = bucket

    def _begin_admission(self, slot: int, req: _Request) -> None:
        """Chunked-prefill admission: reserve the slot and stage a fresh
        batch-1 cache; ``_step_admissions`` advances it a block at a time."""
        dec, cfg = self._dec, self.cfg
        bucket = self.bucket_for(len(req.toks), req.max_new)
        prompt = dec.pad_left_batch([req.toks], bucket)
        self._reserved.add(slot)
        self._admissions.append({
            "req": req, "slot": slot, "prompt": prompt, "bucket": bucket,
            "pcache": dec.init_cache(cfg, 1, self.device),
            "first_real": torch.tensor([bucket - min(len(req.toks), bucket)],
                                       device=self.device),
            "next": 0, "logits": None,
        })

    def _step_admissions(self) -> None:
        """Advance in-progress admissions by one prefill block each (at most
        ``prefill_budget`` blocks in all this iteration, round-robin) and
        splice the completed ones into their reserved slots."""
        dec, cfg = self._dec, self.cfg
        n = len(self._admissions)
        budget = self.prefill_budget or n
        order = [(self._adm_rr + i) % n for i in range(n)]
        self._adm_rr = (self._adm_rr + budget) % max(1, n)
        advanced, still = set(order[:budget]), []
        for i, adm in enumerate(self._admissions):
            req = adm["req"]
            if i in advanced:
                try:
                    t = min(self.prefill_chunk, adm["bucket"] - adm["next"])
                    block = adm["prompt"][:, adm["next"]:adm["next"] + t]
                    adm["logits"], adm["pcache"] = dec.prefill_block(
                        self.params, adm["pcache"], block, adm["first_real"], cfg, adm["next"])
                    adm["next"] += t
                except Exception as exc:
                    logger.exception("chunked admission failed")
                    self._reserved.discard(adm["slot"])
                    req.err = exc
                    req.event.set()
                    continue
            if adm["next"] < adm["bucket"]:
                still.append(adm)
                continue
            slot = adm["slot"]
            dec.insert_slot(self._state, adm["pcache"], adm["logits"], adm["prompt"],
                            dec._enc.prng_key(req.seed), slot, cfg)
            self._reserved.discard(slot)
            self._active[slot] = req
            self._host_pos[slot] = adm["bucket"]
        self._admissions = still

    def _run_chunk(self) -> None:
        dec = self._dec
        t = self.chunk
        live = [s for s in range(self.slots) if self._active[s] is not None]
        attend = dec.attend_window(self.cfg, max(self._host_pos[s] for s in live), t)
        toks = dec.decode_chunk(self.params, self._state, self.cfg, t, self.temperature,
                                attend)
        rows = toks.cpu().numpy()  # the one readback a chunk
        self.chunks_run += 1
        for s in live:
            req = self._active[s]
            for tok in rows[s]:
                tok = int(tok)
                if tok in (dec.EOS, dec.PAD):
                    req.done = True
                    break
                req.tokens.append(tok)
                if len(req.tokens) >= req.max_new:
                    req.done = True
                    break
            self._host_pos[s] += t
            if req.done:
                self._active[s] = None
                req.event.set()

    def _retire_stale(self) -> None:
        """Freeze the device slots whose request was retired without EOS
        (budget hit): their done flag must flip so they stop consuming
        positions."""
        inactive = torch.tensor([self._active[s] is None for s in range(self.slots)],
                                device=self.device)
        self._state.done[: self.slots] |= inactive

    def _fail_all(self, exc: Exception) -> None:
        for s in range(self.slots):
            if self._active[s] is not None:
                self._active[s].err = exc
                self._active[s].event.set()
                self._active[s] = None
        for adm in self._admissions:
            adm["req"].err = exc
            adm["req"].event.set()
        self._admissions.clear()
        self._reserved.clear()

    def _loop(self) -> None:
        try:
            self._state = self._init_state()
        except Exception as exc:
            logger.exception("continuous batcher init failed")
            with self._cond:
                for r in self._pending:
                    r.err = exc
                    r.event.set()
                self._pending.clear()
            return
        while True:
            with self._cond:
                while (not self._stop and not self._pending
                       and all(r is None for r in self._active) and not self._admissions):
                    self._cond.wait()
                if self._stop:
                    self._fail_all(RuntimeError("batcher shut down"))
                    for r in self._pending:
                        r.err = RuntimeError("batcher shut down")
                        r.event.set()
                    self._pending.clear()
                    return
                pending, self._pending = self._pending, []
            try:
                for k, req in enumerate(pending):
                    slot = next((s for s in range(self.slots)
                                 if self._active[s] is None and s not in self._reserved), None)
                    if slot is None:
                        with self._cond:
                            # keep arrival order ahead of newer submissions
                            self._pending[:0] = pending[k:]
                        break
                    try:
                        if self.prefill_chunk > 0:
                            self._begin_admission(slot, req)
                        else:
                            self._admit(slot, req)
                    except Exception as exc:
                        logger.exception("admission failed")
                        self._reserved.discard(slot)
                        req.err = exc
                        req.event.set()
                if self._admissions:
                    self._step_admissions()
                if any(r is not None for r in self._active):
                    self._run_chunk()
                    self._retire_stale()
            except Exception as exc:
                logger.exception("continuous batcher chunk failed")
                self._fail_all(exc)
                # the state may be half-updated: rebuild it on the same device
                try:
                    self._state = self._init_state()
                except Exception:
                    logger.exception("serving state rebuild failed")
