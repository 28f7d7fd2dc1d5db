"""Local on-card chat provider: models/decoder.py behind the IAiChatClient
contract (complete(AiChatRequest) -> AiChatResponse, IAiChatClient.cs:5-9);
PyTorch port of omni_recall_tpu/chat/local.py.

NEW vs the reference, whose chat providers are all remote HTTPS
(GeminiChatClient.cs / GitHubModelsChatClient.cs). With
Embeddings:Provider=Local the whole stack is self-contained on the card: no
API key, no network. Selected with Ai:Provider=Local; quality is whatever
the configured checkpoint was trained to do (Ai:LocalCheckpoint, either
package's ``save_params`` .npz, e.g. from
``python -m omni_recall_tpu_torch.tools.train_chat_demo``); the seed-0
default is an untrained model, useful for smoke tests.

Serving:
- prompts are left-padded into the buckets 128, 256, 512 (then the window
  left by max_new_tokens),
- the default scheduler is continuous batching (chat/serving.py): requests
  join and leave a persistent S-slot decode loop at chunk boundaries, and
  EOS frees a slot early. Ai:LocalScheduler=coalesce keeps the
  leader/follower whole-generation batcher (``_run_batch``),
- generation is greedy by default (temperature 0); sampling
  (Ai:LocalTemperature) stays reproducible per request under both
  schedulers (the seed is the FNV-1a hash of the prompt).
The decoder runs on CUDA unless ``device="cpu"`` is passed.
"""

from __future__ import annotations

import logging
import threading

from omni_recall_tpu_torch.contracts import AiChatRequest, AiChatResponse

logger = logging.getLogger(__name__)

_PROMPT_BUCKETS = (128, 256, 512)


class LocalDecoderChatClient:
    provider_name = "local"
    _MAX_BATCH = 8  # power-of-two serving batches: 1, 2, 4, 8

    def __init__(self, checkpoint: str = "", max_new_tokens: int = 128,
                 temperature: float = 0.0, seed: int = 0, cfg=None, params=None,
                 scheduler: str = "continuous", slots: int = 4, chunk_tokens: int = 16,
                 prefill_chunk: int = 0, prefill_budget: int = 0,
                 device="cuda") -> None:
        from omni_recall_tpu_torch.models import decoder

        self._dec = decoder
        self._scheduler = (scheduler or "continuous").strip().lower()
        self._slots = max(1, int(slots))
        self._chunk_tokens = max(1, int(chunk_tokens))
        self._prefill_chunk = max(0, int(prefill_chunk))
        self._prefill_budget = max(0, int(prefill_budget))
        self._batcher = None  # chat/serving.py, created lazily
        # serializes the coalescing scheduler's generations (one program at
        # a time on the card, and no duplicate first calls of one bucket)
        self._lock = threading.Lock()
        self._queue_lock = threading.Lock()
        self._queue: list[dict] = []
        if params is not None:
            state, self.cfg = params, cfg or decoder.DecoderConfig()
            self.model = "local-decoder"
        elif checkpoint:
            state, self.cfg = decoder.load_params(checkpoint)
            self.model = f"local-decoder:{checkpoint}"
        else:
            self.cfg = cfg or decoder.DecoderConfig()
            state = decoder.init_params(seed, self.cfg)
            self.model = "local-decoder"
        self.weights = decoder.serving_weights(state, self.cfg, device)
        self.device = self.weights.device
        # cap generation at half the position window so the prompt always
        # keeps at least as much room as the answer
        self.max_new_tokens = max(1, min(max_new_tokens, self.cfg.max_len // 2))
        self.temperature = float(temperature)

    def _bucket_for(self, n_tokens: int) -> int:
        # the fallback is not capped at the last bucket: encode_text already
        # truncated to max_len - max_new - 1 bytes
        return next((b for b in _PROMPT_BUCKETS
                     if b >= n_tokens and b + self.max_new_tokens <= self.cfg.max_len),
                    self.cfg.max_len - self.max_new_tokens)

    def _prompt_tokens(self, prompt: str) -> list[int]:
        return self._dec.encode_text(prompt,
                                     max_bytes=self.cfg.max_len - self.max_new_tokens - 1)

    @staticmethod
    def _seed(prompt: str) -> int:
        # stable across processes (built-in hash() is salted per process)
        from omni_recall_tpu_torch.ops.hashing import fnv1a

        return fnv1a(prompt.encode("utf-8", "surrogatepass")) % (1 << 31)

    def warmup_async(self) -> threading.Thread:
        """Run one maximal-bucket generation in the background so the first
        request finds the kernels loaded and the allocator warm. Grounded
        prompts are almost always truncated to the maximum length."""
        def _warm():
            try:
                toks = self._prompt_tokens("x" * (self.cfg.max_len - self.max_new_tokens - 1))
                if self._scheduler == "continuous":
                    self._get_batcher().generate_sync(toks, 0, self.max_new_tokens)
                    return
                prompt = self._dec.pad_left_batch([toks], self._bucket_for(len(toks)))
                self._dec.generate(self.weights, prompt, self.cfg, self.max_new_tokens, 0,
                                   temperature=self.temperature)
            except Exception as exc:  # generation problems surface
                logger.warning("Local decoder warmup failed: %s", exc)

        t = threading.Thread(target=_warm, daemon=True, name="local-chat-warmup")
        t.start()
        return t

    def _get_batcher(self):
        """The continuous batcher (chat/serving.py), built once; it owns its
        scheduler thread and the serving state on the card."""
        if self._batcher is None:
            with self._queue_lock:
                if self._batcher is None:
                    from omni_recall_tpu_torch.chat.serving import ContinuousBatcher

                    self._batcher = ContinuousBatcher(
                        self._dec, self.weights, self.cfg, slots=self._slots,
                        chunk=self._chunk_tokens, temperature=self.temperature,
                        prompt_buckets=_PROMPT_BUCKETS, prefill_chunk=self._prefill_chunk,
                        prefill_budget=self._prefill_budget)
        return self._batcher

    def shutdown(self) -> None:
        if self._batcher is not None:
            self._batcher.shutdown()

    def complete(self, request: AiChatRequest) -> AiChatResponse:
        toks = self._prompt_tokens(request.prompt)
        seed = self._seed(request.prompt)
        if self._scheduler == "continuous":
            out = self._get_batcher().generate_sync(toks, seed, self.max_new_tokens)
            text = self._dec.decode_tokens(out).strip()
            if not text:
                raise RuntimeError("Local decoder produced an empty answer "
                                   "(untrained or out-of-domain checkpoint).")
            return AiChatResponse(text, self.model, self.provider_name)
        entry = {"toks": toks, "seed": seed, "event": threading.Event(),
                 "text": None, "err": None}
        with self._queue_lock:
            self._queue.append(entry)
        # leader/follower: each thread that wins the lock drains the queue
        # (its own entry included) into one batched generation
        while not entry["event"].is_set():
            with self._lock:
                if entry["event"].is_set():
                    break
                with self._queue_lock:
                    batch = self._queue[: self._MAX_BATCH]
                    del self._queue[: len(batch)]
                if batch:
                    self._run_batch(batch)
        if entry["err"] is not None:
            raise entry["err"]
        return AiChatResponse(entry["text"], self.model, self.provider_name)

    def _run_batch(self, batch: list[dict]) -> None:
        """One generation for up to _MAX_BATCH queued requests. Greedy
        requests batch freely; with temperature > 0 each request keeps its
        own sampling key, so sampled requests run one a generation."""
        try:
            if self.temperature > 0 and len(batch) > 1:
                for e in batch:
                    self._run_batch([e])
                return
            nb = 1
            while nb < len(batch):
                nb *= 2
            bucket = max(self._bucket_for(len(e["toks"])) for e in batch)
            tok_lists = [e["toks"] for e in batch]
            tok_lists += [tok_lists[-1]] * (nb - len(batch))  # filler rows
            prompt = self._dec.pad_left_batch(tok_lists, bucket)
            out = self._dec.generate(self.weights, prompt, self.cfg, self.max_new_tokens,
                                     batch[0]["seed"], temperature=self.temperature)
            rows = out.cpu().numpy()
            for i, e in enumerate(batch):
                text = self._dec.decode_tokens(rows[i]).strip()
                if not text:
                    # providers raise on empty output; the router treats it
                    # as a non-transient failure -> recall-only fallback
                    e["err"] = RuntimeError("Local decoder produced an empty answer "
                                            "(untrained or out-of-domain checkpoint).")
                else:
                    e["text"] = text
        except Exception as exc:  # surfaced per request (the router handles it)
            for e in batch:
                if e["err"] is None and e["text"] is None:
                    e["err"] = exc
        finally:
            for e in batch:
                e["event"].set()
