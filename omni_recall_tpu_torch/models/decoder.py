"""Local generative chat model: a compact causal transformer (PyTorch port of
omni_recall_tpu/models/decoder.py).

With the local encoder as the embedding provider it completes the
self-contained stack: ingestion, recall and answer generation all run on
the card with no network dependency (``Ai:Provider=Local``, chat/local.py).

- **byte-level reversible vocabulary**: PAD/BOS/EOS + 256 bytes, padded to
  384 rows,
- **left-padded prompts**: every row of a batch ends at the same position,
- **prefill/decode split**: the prompt runs through one batched pass that
  writes the KV cache [B, max_len, heads, head_dim] (compute dtype); decode
  is a host loop of single-token steps against it, each step's attention
  reading only the attend window (positions [0, al), al rounded up to 128),
- the graph rounds where the JAX graph rounds: bf16 operands upcast (exact)
  and multiplied in f32 with TF32 off, the decode attention's query and the
  cache in bf16, softmax in f32 cast to bf16, tanh GELU, layer norms as
  the encoder's.

The decode steps run every batch on a multiple of ``DECODE_ROWS`` rows
(padding rows are PAD, done, attend to nothing), so ``generate`` and the
continuous batcher (chat/serving.py) hand the card the same shapes: a
slot's greedy stream is then bit for bit ``generate``'s for its prompt at
the same attend window. Sampling reproduces JAX's keys (``split``, threefry
on the device) and its Gumbel draws (``categorical``), the logs taken in
float64 and rounded to f32; a stream is a pure function of (prompt, seed).

Parameters keep the JAX pytree's names (``tok_embed``, ``lm_head``,
``layers.0.wq``, ...), and ``save_params`` / ``load_params`` write and read
the JAX package's .npz scheme, so checkpoints cross both ways. Entry points
run on CUDA unless ``device="cpu"`` is passed; the functions run on the
device their parameters lie on.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from omni_recall_tpu_torch.models import encoder as _enc

PAD, BOS, EOS = 0, 1, 2
_BYTE0 = 3  # byte b encodes as _BYTE0 + b
DECODE_ROWS = 8  # decode steps run on a multiple of this many rows
_NEG = -1e30


@dataclass(frozen=True)
class DecoderConfig:
    vocab_size: int = 384  # 259 used; padded
    d_model: int = 256
    n_layers: int = 4
    n_heads: int = 4
    d_ff: int = 1024
    max_len: int = 640  # prompt buffer + generated tokens
    compute_dtype: str = "bfloat16"

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads


# -- tokenization (reversible, byte-level) ------------------------------------


def encode_text(text: str, max_bytes: int | None = None) -> list[int]:
    data = text.encode("utf-8", errors="surrogatepass")
    if max_bytes is not None and len(data) > max_bytes:
        # keep the tail (max_bytes=0 truncates to nothing)
        data = data[len(data) - max_bytes:]
    return [BOS] + [_BYTE0 + b for b in data]


def decode_tokens(tokens) -> str:
    data = bytes(int(t) - _BYTE0 for t in tokens if _BYTE0 <= int(t) < _BYTE0 + 256)
    return data.decode("utf-8", errors="replace")


def pad_left_batch(token_lists: list[list[int]], length: int) -> np.ndarray:
    """Left-pad to [B, length] so all rows end at position length-1."""
    out = np.zeros((len(token_lists), length), dtype=np.int32)
    for i, toks in enumerate(token_lists):
        toks = toks[-length:]
        out[i, length - len(toks):] = toks
    return out


# -- parameters -----------------------------------------------------------------


def init_tree(seed: int, cfg: DecoderConfig) -> dict:
    """``init_params(PRNGKey(seed), cfg)`` of the JAX package as a pytree of
    numpy f32 arrays (the encoder's threefry ``split`` and ``normal``)."""
    keys = iter(_enc.split(_enc.prng_key(seed), 3 + 8 * cfg.n_layers))

    def dense(k, shape, scale=None):
        scale = scale if scale is not None else 1.0 / np.sqrt(shape[0])
        return _enc.normal(k, shape) * np.float32(scale)

    def norm():
        return {"scale": np.ones(cfg.d_model, np.float32),
                "bias": np.zeros(cfg.d_model, np.float32)}

    tree: dict = {
        "tok_embed": dense(next(keys), (cfg.vocab_size, cfg.d_model), scale=0.02),
        "pos_embed": dense(next(keys), (cfg.max_len, cfg.d_model), scale=0.02),
        "lm_head": dense(next(keys), (cfg.d_model, cfg.vocab_size)),
        "final_ln": norm(),
        "layers": [],
    }
    for _ in range(cfg.n_layers):
        tree["layers"].append({
            "ln1": norm(), "ln2": norm(),
            "wq": dense(next(keys), (cfg.d_model, cfg.d_model)),
            "wk": dense(next(keys), (cfg.d_model, cfg.d_model)),
            "wv": dense(next(keys), (cfg.d_model, cfg.d_model)),
            "wo": dense(next(keys), (cfg.d_model, cfg.d_model)),
            "w1": dense(next(keys), (cfg.d_model, cfg.d_ff)),
            "b1": np.zeros(cfg.d_ff, np.float32),
            "w2": dense(next(keys), (cfg.d_ff, cfg.d_model)),
            "b2": np.zeros(cfg.d_model, np.float32),
        })
    return tree


def init_params(seed: int, cfg: DecoderConfig) -> dict[str, torch.Tensor]:
    """The JAX package's seed init as the port's state (f32 CPU tensors)."""
    return _enc.params_from_numpy(init_tree(seed, cfg))


def param_specs(cfg: DecoderConfig) -> dict[str, tuple]:
    """The decoder's partition specs (decoder.py:122; the encoder's recipe,
    ``encoder.param_specs``): the state dict's keys with the mesh-axis names
    of each JAX ``PartitionSpec``, the vocabulary head split on ``model``."""
    specs = {"tok_embed": ("model", None), "pos_embed": (), "lm_head": (None, "model"),
             "final_ln.scale": (), "final_ln.bias": ()}
    for i in range(cfg.n_layers):
        specs.update({f"layers.{i}.{k}": v for k, v in _enc.LAYER_SPECS.items()})
    return specs


_MATRICES = ("wq", "wk", "wv", "wo", "w1", "w2")


class Weights:
    """The parameters as the graph reads them: the f32 state (``p``) and,
    per layer, every leaf cast to the compute dtype, the matrices then
    upcast to f32 (exact) for the f32 products. Built from a state dict
    that requires grad, the casts stay on the autograd graph (training);
    built once for serving, they are cast once."""

    def __init__(self, params: dict[str, torch.Tensor], cfg: DecoderConfig) -> None:
        dtype = getattr(torch, cfg.compute_dtype)
        self.cfg, self.p = cfg, params
        self.layers = []
        for i in range(cfg.n_layers):
            layer = {name: params[f"layers.{i}.{name}"].to(dtype) for name in _enc.LAYER_KEYS}
            layer.update({name: layer[name].float() for name in _MATRICES})
            self.layers.append(layer)

    @property
    def device(self) -> torch.device:
        return self.p["tok_embed"].device


def serving_weights(params, cfg: DecoderConfig, device="cuda") -> Weights:
    """Serving copies of ``params`` (a state dict) on ``device``."""
    from omni_recall_tpu_torch.device import resolve_device

    dev = resolve_device(device)
    return Weights({k: torch.as_tensor(v, dtype=torch.float32).detach().to(dev)
                    for k, v in params.items()}, cfg)


def _weights(params, cfg: DecoderConfig) -> Weights:
    return params if isinstance(params, Weights) else Weights(params, cfg)


def _mm(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return torch.matmul(a.float(), w)


def _ffn(h, layer):
    ff = _mm(h, layer["w1"]) + layer["b1"]
    ff = torch.nn.functional.gelu(ff, approximate="tanh").to(h.dtype)
    return _mm(ff, layer["w2"]) + layer["b2"]


def _embed(w: Weights, ids: torch.Tensor, positions) -> torch.Tensor:
    dtype = getattr(torch, w.cfg.compute_dtype)
    x = torch.nn.functional.embedding(ids, w.p["tok_embed"]) + w.p["pos_embed"][positions]
    return x.to(dtype)


def _final(w: Weights, x: torch.Tensor) -> torch.Tensor:
    x = _enc._layer_norm(x.float(), w.p["final_ln.scale"], w.p["final_ln.bias"])
    return torch.matmul(x, w.p["lm_head"])


def _attend(q, k, v, mask, dtype) -> torch.Tensor:
    """Attention of queries [b, l, h, e] over keys and values [b, m, h, e]:
    f32 products, the logits masked to -1e30 where ``mask`` [b, l, m] is
    False, the softmax in f32 cast to the compute dtype. Returns
    [b, l, h * e] f32."""
    b, l, h, e = q.shape
    logits = torch.einsum("blhe,bmhe->bhlm", q.float(), k.float()) / np.float32(np.sqrt(e))
    logits = torch.where(mask[:, None], logits,
                         torch.tensor(_NEG, dtype=torch.float32, device=logits.device))
    weights = torch.softmax(logits, dim=-1).to(dtype).float()
    return torch.einsum("bhlm,bmhe->blhe", weights, v.float()).reshape(b, l, h * e)


def _layer(x, layer, attention) -> torch.Tensor:
    """One pre-norm layer: x + wo(attention(ln1(x))), then x + ffn(ln2(x)),
    each residual added in the compute dtype; ``attention(h)`` returns the
    heads' outputs in f32."""
    dtype = x.dtype
    h = _enc._layer_norm(x, layer["ln1.scale"], layer["ln1.bias"])
    x = x + _mm(attention(h).to(dtype), layer["wo"]).to(dtype)
    h = _enc._layer_norm(x, layer["ln2.scale"], layer["ln2.bias"])
    return x + _ffn(h, layer).to(dtype)


# -- training forward (teacher forcing, causal mask) ----------------------------


def _full_pass(w: Weights, token_ids: torch.Tensor, cache=None):
    """The whole-sequence pass of ``forward`` and ``prefill``: hidden states
    [B, L, d] (compute dtype), writing each layer's k/v into ``cache``."""
    from omni_recall_tpu_torch.ops.scorer import _no_tf32

    cfg = w.cfg
    dtype = getattr(torch, cfg.compute_dtype)
    b, l = token_ids.shape
    valid = token_ids != PAD
    causal = torch.tril(torch.ones(l, l, dtype=torch.bool, device=token_ids.device))
    mask = causal[None, :, :] & valid[:, None, :]

    def attention(li, layer):
        def attend(h):
            q, k, v = (_mm(h, layer[n]).reshape(b, l, cfg.n_heads, cfg.head_dim)
                       for n in ("wq", "wk", "wv"))
            if cache is not None:
                cache[li]["k"][:b, :l] = k.to(dtype)
                cache[li]["v"][:b, :l] = v.to(dtype)
            return _attend(q, k, v, mask, dtype)
        return attend

    with _no_tf32():
        x = _embed(w, token_ids, slice(0, l))
        for li, layer in enumerate(w.layers):
            x = _layer(x, layer, attention(li, layer))
    return x


def forward(params, token_ids, cfg: DecoderConfig) -> torch.Tensor:
    """token_ids int[B, L] -> logits f32[B, L, vocab]. PAD positions attend
    to nothing and nothing attends to them."""
    from omni_recall_tpu_torch.ops.scorer import _no_tf32

    w = _weights(params, cfg)
    x = _full_pass(w, _ids(token_ids, w.device))
    with _no_tf32():
        return _final(w, x)


# -- serving: prefill + KV-cache decode ------------------------------------------


def init_cache(cfg: DecoderConfig, batch: int, device="cpu") -> list[dict]:
    dtype = getattr(torch, cfg.compute_dtype)
    shape = (batch, cfg.max_len, cfg.n_heads, cfg.head_dim)
    return [{"k": torch.zeros(shape, dtype=dtype, device=device),
             "v": torch.zeros(shape, dtype=dtype, device=device)}
            for _ in range(cfg.n_layers)]


def _ids(token_ids, device) -> torch.Tensor:
    if isinstance(token_ids, torch.Tensor):
        return token_ids.to(device).long()
    return torch.from_numpy(np.asarray(token_ids, dtype=np.int64)).to(device)


def prefill(params, token_ids, cfg: DecoderConfig, rows: int | None = None):
    """Left-padded prompt i32[B, Lp] -> (last-position logits f32[B, vocab],
    cache filled for positions [0, Lp)). ``rows`` (>= B) sizes the cache:
    rows past B stay zero."""
    from omni_recall_tpu_torch.ops.scorer import _no_tf32

    w = _weights(params, cfg)
    ids = _ids(token_ids, w.device)
    with torch.no_grad():
        cache = init_cache(cfg, rows or ids.shape[0], w.device)
        x = _full_pass(w, ids, cache)
        with _no_tf32():
            return _final(w, x[:, -1]), cache


def prefill_block(params, cache: list[dict], block, first_real, cfg: DecoderConfig,
                  start: int):
    """One chunked-prefill block: prompt positions [start, start+T) of a
    left-padded batch against the cache prefix, writing this block's k/v
    into the cache (in place). ``first_real`` i32[B] is each row's first
    non-PAD position. Earlier blocks' keys and values are read back from
    the compute-dtype cache, as decode reads them, so a chain of blocks
    matches ``prefill`` up to that rounding. Returns (last-position logits
    f32[B, vocab], cache)."""
    from omni_recall_tpu_torch.ops.scorer import _no_tf32

    w = _weights(params, cfg)
    dtype = getattr(torch, cfg.compute_dtype)
    blk = _ids(block, w.device)
    first = _ids(first_real, w.device)
    b, t = blk.shape
    al = start + t
    jpos = torch.arange(al, device=w.device)[None, None, :]
    qpos = (start + torch.arange(t, device=w.device))[None, :, None]
    mask = (jpos <= qpos) & (jpos >= first[:, None, None])

    def attention(layer, ck, cv):
        def attend(h):
            q, k, v = (_mm(h, layer[n]).reshape(b, t, cfg.n_heads, cfg.head_dim)
                       for n in ("wq", "wk", "wv"))
            ck[:, start:al], cv[:, start:al] = k.to(dtype), v.to(dtype)
            return _attend(q.to(dtype), ck[:, :al], cv[:, :al], mask, dtype)
        return attend

    with torch.no_grad(), _no_tf32():
        x = _embed(w, blk, slice(start, al))
        for li, layer in enumerate(w.layers):
            x = _layer(x, layer, attention(layer, cache[li]["k"], cache[li]["v"]))
        return _final(w, x[:, -1]), cache


def prefill_chunked(params, token_ids, cfg: DecoderConfig, chunk: int):
    """``prefill`` through ``prefill_block`` chunks. Returns (last-position
    logits, cache)."""
    w = _weights(params, cfg)
    ids = _ids(token_ids, w.device)
    b, lp = ids.shape
    valid = ids != PAD
    first_real = torch.where(valid.any(dim=1), valid.int().argmax(dim=1),
                             torch.full((b,), lp, device=ids.device))
    cache = init_cache(cfg, b, w.device)
    logits = None
    for start in range(0, lp, chunk):
        t = min(chunk, lp - start)
        logits, cache = prefill_block(w, cache, ids[:, start:start + t], first_real, cfg, start)
    return logits, cache


def _decode_rows(w: Weights, cache, token: torch.Tensor, pos: torch.Tensor,
                 key_valid: torch.Tensor, al: int):
    """One token a row at its own position ``pos`` i64[R]: writes the rows'
    k/v at ``pos`` (in place) and attends to the cache window [0, al)
    masked to positions <= pos that ``key_valid`` marks. Row-local: a row's
    logits depend only on its own inputs."""
    from omni_recall_tpu_torch.ops.scorer import _no_tf32

    cfg = w.cfg
    dtype = getattr(torch, cfg.compute_dtype)
    s = token.shape[0]
    rows = torch.arange(s, device=token.device)
    pos_mask = (torch.arange(al, device=token.device)[None, :] <= pos[:, None]) \
        & key_valid[:, :al]

    def attention(layer, ck, cv):
        def attend(h):
            q, k, v = (_mm(h, layer[n]).reshape(s, 1, cfg.n_heads, cfg.head_dim)
                       for n in ("wq", "wk", "wv"))
            ck[rows, pos], cv[rows, pos] = k[:, 0].to(dtype), v[:, 0].to(dtype)
            return _attend(q.to(dtype), ck[:, :al], cv[:, :al], pos_mask[:, None], dtype)
        return attend

    with _no_tf32():
        x = _embed(w, token, pos)[:, None]
        for li, layer in enumerate(w.layers):
            x = _layer(x, layer, attention(layer, cache[li]["k"], cache[li]["v"]))
        return _final(w, x[:, 0])


def decode_step(params, cache: list[dict], token, pos: int, cfg: DecoderConfig,
                key_valid=None, attend_len: int | None = None):
    """One token i32[B] at scalar position ``pos`` -> (logits f32[B, vocab],
    cache updated in place). ``key_valid`` bool[B, max_len] marks cache
    positions holding real tokens (left-PAD prompt positions must be
    excluded); ``attend_len`` bounds the cache read window."""
    w = _weights(params, cfg)
    tok = _ids(token, w.device)
    al = cfg.max_len if attend_len is None else min(attend_len, cfg.max_len)
    if key_valid is None:
        key_valid = torch.ones(tok.shape[0], cfg.max_len, dtype=torch.bool, device=w.device)
    posv = torch.full((tok.shape[0],), int(pos), dtype=torch.long, device=w.device)
    with torch.no_grad():
        return _decode_rows(w, cache, tok, posv, key_valid.to(w.device), al), cache


def decode_step_multi(params, cache: list[dict], token, pos, cfg: DecoderConfig,
                      key_valid, attend_len: int):
    """``decode_step`` with a per-slot position vector ``pos`` i32[S]: each
    slot writes its k/v at its own position and attends to its own prefix."""
    w = _weights(params, cfg)
    with torch.no_grad():
        return _decode_rows(w, cache, _ids(token, w.device), _ids(pos, w.device),
                            key_valid, min(attend_len, cfg.max_len)), cache


# -- sampling: JAX's keys and Gumbel draws on the device --------------------------

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def threefry2x32_t(k1, k2, x1: torch.Tensor, x2: torch.Tensor):
    """threefry2x32 (20 rounds) on int64 tensors holding uint32 values (keys
    broadcast against the counters): the encoder's numpy ``threefry2x32``
    on the device."""
    k1, k2 = k1 & _M32, k2 & _M32
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    a, b = (x1 + ks[0]) & _M32, (x2 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            a = (a + b) & _M32
            b = (((b << r) & _M32) | (b >> (32 - r))) ^ a
        a = (a + ks[(i + 1) % 3]) & _M32
        b = (b + ks[(i + 2) % 3] + (i + 1)) & _M32
    return a, b


def split_keys(keys: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``jax.random.split(k)`` of each row of int64[R, 2] keys: (next keys,
    sub keys), each [R, 2]."""
    iota = torch.arange(2, device=keys.device, dtype=torch.long)[None, :]
    b1, b2 = threefry2x32_t(keys[:, :1], keys[:, 1:], torch.zeros_like(iota), iota)
    return torch.stack([b1[:, 0], b2[:, 0]], 1), torch.stack([b1[:, 1], b2[:, 1]], 1)


def gumbel(keys: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.gumbel(k, (n,), float32)`` for each row of int64[R, 2]
    keys: -log(-log(u)), u the uniform draws on [tiny, 1) from threefry over
    the iota [0, n); the logs in float64, rounded to f32."""
    iota = torch.arange(n, device=keys.device, dtype=torch.long)[None, :]
    b1, b2 = threefry2x32_t(keys[:, :1], keys[:, 1:], torch.zeros_like(iota), iota)
    bits = ((b1 ^ b2) >> 9) | 0x3F800000
    u = bits.to(torch.int32).view(torch.float32) - 1.0
    tiny = float(np.finfo(np.float32).tiny)
    u = torch.clamp_min(u + tiny, tiny)
    inner = (-torch.log(u.double())).float()
    return (-torch.log(inner.double())).float()


def emit_mask(cfg: DecoderConfig, device) -> torch.Tensor:
    """Only bytes and EOS are emittable (PAD, BOS and the padded vocab tail
    are structural)."""
    ok = torch.zeros(cfg.vocab_size, dtype=torch.bool, device=device)
    ok[EOS] = True
    ok[_BYTE0:_BYTE0 + 256] = True
    return ok


def sample(logits: torch.Tensor, emit_ok: torch.Tensor, temperature: float,
           subkeys: torch.Tensor | None = None) -> torch.Tensor:
    """Greedy (temperature <= 0) or JAX's ``categorical``: argmax of the
    Gumbel draws (one key a row) plus logits / temperature."""
    logits = torch.where(emit_ok[None, :], logits,
                         torch.tensor(_NEG, dtype=logits.dtype, device=logits.device))
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1)
    return torch.argmax(gumbel(subkeys, logits.shape[1]) + logits / temperature, dim=-1)


def _key_tensor(key, device) -> torch.Tensor:
    key = _enc.prng_key(key) if isinstance(key, (int, np.integer)) else np.asarray(key)
    return torch.tensor(np.asarray(key, dtype=np.int64).reshape(1, 2), device=device)


def _round_rows(b: int) -> int:
    return -(-b // DECODE_ROWS) * DECODE_ROWS


def attend_window(cfg: DecoderConfig, lp: int, n_steps: int, full_window: bool = False) -> int:
    """The cache read window of a call: lp + n_steps rounded up to 128."""
    return cfg.max_len if full_window else min(cfg.max_len, -(-(lp + n_steps) // 128) * 128)


def generate(params, prompt_ids, cfg: DecoderConfig, n_steps: int, key=0,
             temperature: float = 0.0, full_window: bool = False) -> torch.Tensor:
    """Left-padded prompts i32[B, Lp] -> generated tokens i64[B, n_steps] on
    the parameters' device. Greedy when temperature <= 0, else categorical
    sampling: JAX's per-step ``split`` of ``key`` (a seed or a uint32[2]
    key) and one Gumbel draw of [B, vocab] a step. Tokens after a row's EOS
    are PAD."""
    w = _weights(params, cfg)
    prompt = _ids(prompt_ids, w.device)
    b, lp = prompt.shape
    if lp + n_steps > cfg.max_len:
        raise ValueError(f"prompt length {lp} + n_steps {n_steps} exceeds "
                         f"cfg.max_len {cfg.max_len}")
    rows = _round_rows(b)
    dev = w.device
    with torch.no_grad():
        logits0, cache = prefill(w, prompt, cfg, rows=rows)
        logits = torch.zeros(rows, cfg.vocab_size, dtype=torch.float32, device=dev)
        logits[:b] = logits0
        key_valid = torch.zeros(rows, cfg.max_len, dtype=torch.bool, device=dev)
        key_valid[:b, :lp] = prompt != PAD
        key_valid[:b, lp:] = True
        done = torch.ones(rows, dtype=torch.bool, device=dev)
        done[:b] = False
        emit_ok = emit_mask(cfg, dev)
        al = attend_window(cfg, lp, n_steps, full_window)
        k = _key_tensor(key, dev)
        out = torch.zeros(rows, n_steps, dtype=torch.long, device=dev)
        pad = torch.full((rows,), PAD, dtype=torch.long, device=dev)
        for step in range(n_steps):
            if temperature > 0.0:
                k, sub = split_keys(k)
                tok = torch.full((rows,), PAD, dtype=torch.long, device=dev)
                noise = gumbel(sub, b * cfg.vocab_size).reshape(b, cfg.vocab_size)
                masked = torch.where(emit_ok[None, :], logits[:b],
                                     torch.tensor(_NEG, device=dev))
                tok[:b] = torch.argmax(noise + masked / temperature, dim=-1)
            else:
                tok = sample(logits, emit_ok, 0.0)
            tok = torch.where(done, pad, tok)
            done = done | (tok == EOS)
            out[:, step] = tok
            if step + 1 == n_steps:
                break
            key_valid[:, lp + step] &= tok != PAD
            posv = torch.full((rows,), lp + step, dtype=torch.long, device=dev)
            logits = _decode_rows(w, cache, tok, posv, key_valid, al)
    return out[:b]


# -- serving: per-slot continuous decode (chat/serving.py) ------------------------


class SlotState:
    """The continuous batcher's serving state on the card, ``rows`` =
    slots rounded up to DECODE_ROWS: the KV cache [rows, max_len, ...],
    next-token logits, positions, done flags, key validity and per-slot
    sampling keys. Updated in place."""

    def __init__(self, cfg: DecoderConfig, slots: int, device) -> None:
        rows = _round_rows(slots)
        self.cache = init_cache(cfg, rows, device)
        self.logits = torch.zeros(rows, cfg.vocab_size, dtype=torch.float32, device=device)
        self.pos = torch.zeros(rows, dtype=torch.long, device=device)
        self.done = torch.ones(rows, dtype=torch.bool, device=device)  # empty slots emit PAD
        self.kv = torch.zeros(rows, cfg.max_len, dtype=torch.bool, device=device)
        self.keys = torch.zeros(rows, 2, dtype=torch.long, device=device)


def decode_chunk(params, state: SlotState, cfg: DecoderConfig, n_steps: int,
                 temperature: float, attend_len: int) -> torch.Tensor:
    """``n_steps`` continuous-batching decode steps over the state's slots,
    in place: each slot samples with its own key (split each sampled step;
    greedy decoding draws none), writes
    at its own position and stops at EOS (done slots emit PAD and freeze).
    Returns the tokens i64[rows, n_steps] on the device: the caller's one
    readback a chunk."""
    w = _weights(params, cfg)
    dev = state.logits.device
    emit_ok = emit_mask(cfg, dev)
    rows = torch.arange(state.pos.shape[0], device=dev)
    pad = torch.full_like(state.pos, PAD)
    out = torch.zeros(state.pos.shape[0], n_steps, dtype=torch.long, device=dev)
    al = min(attend_len, cfg.max_len)
    with torch.no_grad():
        for step in range(n_steps):
            # a slot whose window is exhausted freezes
            state.done |= state.pos >= cfg.max_len
            wp = torch.clamp_max(state.pos, cfg.max_len - 1)
            subs = None
            if temperature > 0.0:  # greedy draws no keys
                state.keys, subs = split_keys(state.keys)
            tok = sample(state.logits, emit_ok, temperature, subs)
            tok = torch.where(state.done, pad, tok)
            state.done |= tok == EOS
            state.kv[rows, wp] = tok != PAD  # a PAD write never becomes attendable
            state.logits = _decode_rows(w, state.cache, tok, wp, state.kv, al)
            state.pos = torch.where(state.done, state.pos, state.pos + 1)
            out[:, step] = tok
    return out


def insert_slot(state: SlotState, prefill_cache: list[dict], prefill_logits: torch.Tensor,
                prompt_ids, seed_key, slot: int, cfg: DecoderConfig) -> SlotState:
    """Install a batch-1 prefilled request (its cache, last-position logits,
    left-padded prompt and sampling key) into slot ``slot``, in place."""
    prompt = _ids(prompt_ids, state.logits.device)
    lp = prompt.shape[1]
    for li in range(cfg.n_layers):
        for name in ("k", "v"):
            state.cache[li][name][slot] = prefill_cache[li][name][0]
    state.kv[slot] = False
    state.kv[slot, :lp] = prompt[0] != PAD
    state.logits[slot] = prefill_logits[0]
    state.pos[slot] = lp
    state.done[slot] = False
    state.keys[slot] = _key_tensor(seed_key, state.logits.device)[0]
    return state


# -- training -------------------------------------------------------------------


def lm_loss(params, token_ids, cfg: DecoderConfig) -> torch.Tensor:
    """Next-token cross-entropy over non-PAD targets whose input is not PAD
    either (a fully masked softmax attends to every key, future ones too)."""
    w = _weights(params, cfg)
    ids = _ids(token_ids, w.device)
    logits = forward(w, ids[:, :-1], cfg)
    targets = ids[:, 1:]
    mask = ((targets != PAD) & (ids[:, :-1] != PAD)).float()
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, 2, targets[:, :, None])[:, :, 0]
    return (nll * mask).sum() / torch.clamp_min(mask.sum(), 1.0)


def make_train_step(cfg: DecoderConfig, optimizer: _enc.AdamW | None = None):
    """(optimizer, train_step) with ``train_step(params, opt_state,
    token_ids) -> (params, opt_state, loss)``: AdamW(3e-4) by default, the
    encoder's ``optax.adamw`` in torch; ``params`` are master copies
    (``encoder.trainable``), updated in place."""
    optimizer = optimizer or _enc.AdamW(3e-4)

    def train_step(params, opt_state, token_ids):
        loss, grads = _enc.value_and_grad(lm_loss, params, token_ids, cfg)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        return _enc.apply_updates(params, updates), opt_state, loss

    return optimizer, train_step


# -- checkpointing (the encoder's .npz scheme) --------------------------------------


def save_params(path: str, params, cfg: DecoderConfig) -> None:
    _enc.save_params(path, params.p if isinstance(params, Weights) else params, cfg)


def load_params(path: str) -> tuple[dict[str, torch.Tensor], DecoderConfig]:
    return _enc.load_checkpoint(path, DecoderConfig)
