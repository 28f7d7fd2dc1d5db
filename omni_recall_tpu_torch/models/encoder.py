"""Local text embedder: a compact transformer encoder as an ``nn.Module``
(PyTorch port of omni_recall_tpu/models/encoder.py, serving part).

A hashed-vocabulary transformer encoder producing L2-normalized text
embeddings compatible with the device index. The graph is written as the
JAX graph is: every matrix product takes its operands in the compute dtype
(bf16 by default) and sums in f32 (``preferred_element_type=float32``: here
the operands are upcast, which is exact, and multiplied in full f32 with
TF32 off), attention is an explicit einsum with the ``-1e30`` mask and an
f32 softmax cast to the compute dtype, GELU is the tanh form
(``jax.nn.gelu``'s default), the layer norm takes the population variance
with eps 1e-6, and the final norm, pool and projection run in f32.

Parameters keep the JAX pytree's names: the module's ``state_dict`` keys
(``tok_embed``, ``final_ln.scale``, ``layers.0.wq``, ...) are the flattened
paths ``save_params`` writes, so a checkpoint crosses between the packages
both ways. ``init_params(seed)`` reproduces ``init_params(PRNGKey(seed))``
of the JAX package from numpy: threefry2x32 over a 64-bit iota
(``split``, bit for bit), the uniform bits of ``jax.random.uniform`` and
XLA's f32 inverse error function (``normal``, within a few f32 ulps of
JAX's weights).

Training is plain autograd through the same graph (``encode``):
``info_nce_loss``, ``make_train_step`` with ``AdamW`` (``optax.adamw``
written in torch) and ``sgd_train_step``; ``trainable`` makes the f32
master copies and ``tree_from_state`` turns a state dict back into the JAX
pytree. ``param_specs`` records the JAX package's partition specs (its
mesh-axis names a state-dict key); nothing in the port shards the models.
"""

from __future__ import annotations

import functools
import json
import math
from dataclasses import dataclass

import numpy as np
import torch
from torch import nn

from omni_recall_tpu_torch.ops.hashing import fnv1a


@dataclass(frozen=True)
class EncoderConfig:
    vocab_size: int = 32768
    d_model: int = 256
    n_layers: int = 4
    n_heads: int = 4
    d_ff: int = 1024
    max_len: int = 128
    out_dim: int = 768
    compute_dtype: str = "bfloat16"

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads


@functools.lru_cache(maxsize=1 << 20)
def _word_id(word: str, vocab_size: int) -> int:
    return 1 + fnv1a(word.encode("utf-8", errors="surrogatepass"), seed=11) % (vocab_size - 1)


def tokenize(text: str, cfg: EncoderConfig) -> np.ndarray:
    """Hash words to token ids in [1, vocab); 0 is padding."""
    ids = [_word_id(w, cfg.vocab_size) for w in text.lower().split()[: cfg.max_len]]
    out = np.zeros(cfg.max_len, dtype=np.int32)
    out[: len(ids)] = ids
    return out


def tokenize_batch(texts: list[str], cfg: EncoderConfig) -> np.ndarray:
    out = np.zeros((len(texts), cfg.max_len), dtype=np.int32)
    for row, text in zip(out, texts):
        ids = [_word_id(w, cfg.vocab_size) for w in text.lower().split()[: cfg.max_len]]
        row[: len(ids)] = ids
    return out


# -- the JAX package's seed init, in numpy ------------------------------------

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(v: np.ndarray, r: int) -> np.ndarray:
    return (v << np.uint32(r)) | (v >> np.uint32(32 - r))


def threefry2x32(k1, k2, x1: np.ndarray, x2: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Threefry-2x32, 20 rounds (Salmon et al. 2011), as jax.random's
    ``threefry2x32_p`` computes it, on uint32 arrays."""
    k1, k2 = np.uint32(k1), np.uint32(k2)
    ks = (k1, k2, k1 ^ k2 ^ np.uint32(0x1BD11BDA))
    x = [x1.astype(np.uint32) + ks[0], x2.astype(np.uint32) + ks[1]]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x[0] = x[0] + x[1]
            x[1] = _rotl(x[1], r) ^ x[0]
        x[0] = x[0] + ks[(i + 1) % 3]
        x[1] = x[1] + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x[0], x[1]


def prng_key(seed: int) -> np.ndarray:
    """``jax.random.PRNGKey(seed)`` (threefry, 32-bit seeds): [0, seed]."""
    if not 0 <= seed < 2**31:
        raise ValueError(f"seed {seed} outside [0, 2^31)")
    return np.array([0, seed], dtype=np.uint32)


def _iota_bits(key: np.ndarray, n: int) -> tuple[np.ndarray, np.ndarray]:
    """threefry2x32 over the 64-bit iota [0, n) split into its high and low
    words (``jax_threefry_partitionable``'s counter layout)."""
    idx = np.arange(n, dtype=np.uint64)
    hi = (idx >> np.uint64(32)).astype(np.uint32)
    lo = (idx & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    with np.errstate(over="ignore"):
        return threefry2x32(key[0], key[1], hi, lo)


def split(key: np.ndarray, num: int) -> np.ndarray:
    """``jax.random.split(key, num)``: uint32[num, 2]."""
    b1, b2 = _iota_bits(key, num)
    return np.stack([b1, b2], axis=1)


# XLA's f32 inverse error function (Giles, "Approximating the erfinv
# function", GPU Computing Gems 2011): degree-8 polynomials in w = -log1p(-x^2)
_ERFINV_W_LT_5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
                  0.00021858087, -0.00125372503, -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_W_GE_5 = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
                  0.00573950773, -0.0076224613, 0.00943887047, 1.00167406, 2.83297682)


def erfinv32(x: np.ndarray) -> np.ndarray:
    """XLA's f32 ``erf_inv`` on f32 ``x`` in (-1, 1), its Horner steps as
    the CPU jit contracts them (fused multiply-adds, here exact in float64
    and rounded once). Its ``log1p`` is XLA's own, which this takes in
    float64: 99% of the results are XLA's bits, the rest within 2.4e-7."""
    x = x.astype(np.float32)
    w = (-np.log1p(-(x * x).astype(np.float64))).astype(np.float32)
    lt = w < np.float32(5.0)
    w = np.where(lt, w - np.float32(2.5), np.sqrt(w) - np.float32(3.0)).astype(np.float32)
    coef = [np.where(lt, np.float32(a), np.float32(b))
            for a, b in zip(_ERFINV_W_LT_5, _ERFINV_W_GE_5)]
    p = coef[0]
    for c in coef[1:]:
        p = (p.astype(np.float64) * w + c).astype(np.float32)
    return p * x


def normal(key: np.ndarray, shape: tuple[int, ...]) -> np.ndarray:
    """``jax.random.normal(key, shape, float32)``: the same uniform bits on
    (-1, 1), then sqrt(2) * erfinv32(u)."""
    n = math.prod(shape)
    b1, b2 = _iota_bits(key, n)
    bits = b1 ^ b2
    floats = ((bits >> np.uint32(9)) | np.uint32(0x3F800000)).view(np.float32) - np.float32(1.0)
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0), dtype=np.float32)
    u = np.maximum(lo, floats * (np.float32(1.0) - lo) + lo)
    return (np.float32(np.sqrt(2)) * erfinv32(u)).reshape(shape)


def init_tree(seed: int, cfg: EncoderConfig) -> dict:
    """``init_params(PRNGKey(seed), cfg)`` of the JAX package as a pytree of
    numpy f32 arrays (the same draws in the same order)."""
    keys = iter(split(prng_key(seed), 4 + 8 * cfg.n_layers))

    def dense(k, shape, scale=None):
        scale = scale if scale is not None else 1.0 / np.sqrt(shape[0])
        return normal(k, shape) * np.float32(scale)

    def norm():
        return {"scale": np.ones(cfg.d_model, np.float32),
                "bias": np.zeros(cfg.d_model, np.float32)}

    tree: dict = {
        "tok_embed": dense(next(keys), (cfg.vocab_size, cfg.d_model), scale=0.02),
        "pos_embed": dense(next(keys), (cfg.max_len, cfg.d_model), scale=0.02),
        "out_proj": dense(next(keys), (cfg.d_model, cfg.out_dim)),
        "final_ln": norm(),
        "layers": [],
    }
    for _ in range(cfg.n_layers):
        tree["layers"].append({
            "ln1": norm(),
            "ln2": norm(),
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


def flatten_tree(tree, prefix: str = "") -> dict[str, np.ndarray]:
    """The pytree's leaves under their dotted paths (``save_params``'s keys)."""
    flat: dict[str, np.ndarray] = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            flat.update(flatten_tree(v, f"{prefix}.{k}" if prefix else k))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            flat.update(flatten_tree(v, f"{prefix}.{i}"))
    elif isinstance(tree, torch.Tensor):
        flat[prefix] = tree.detach().cpu().numpy()
    else:
        flat[prefix] = np.asarray(tree)
    return flat


# one layer's mesh-axis names over a ('data', 'model') mesh (encoder.py
# param_specs): tensor parallel on the heads and the FFN
LAYER_SPECS = {
    "ln1.scale": (), "ln1.bias": (), "ln2.scale": (), "ln2.bias": (),
    "wq": (None, "model"), "wk": (None, "model"), "wv": (None, "model"),
    "wo": ("model", None), "w1": (None, "model"), "b1": ("model",),
    "w2": ("model", None), "b2": (),
}


def param_specs(cfg: EncoderConfig) -> dict[str, tuple]:
    """The encoder's partition specs (encoder.py:96): the state dict's keys,
    each with the mesh-axis names of the JAX ``PartitionSpec`` it mirrors,
    one entry a dimension (``("model", None)`` for ``P("model", None)``,
    ``()`` for the replicated ``P()``), over a ('data', 'model') mesh with
    tensor parallelism on the heads, the FFN and the vocabulary. Nothing in
    the port shards the models yet; this records the layout."""
    specs = {"tok_embed": ("model", None), "pos_embed": (), "out_proj": (None, "model"),
             "final_ln.scale": (), "final_ln.bias": ()}
    for i in range(cfg.n_layers):
        specs.update({f"layers.{i}.{k}": v for k, v in LAYER_SPECS.items()})
    return specs


def params_from_numpy(tree) -> dict[str, torch.Tensor]:
    """The JAX package's parameter pytree (numpy leaves, or the flat dict of
    its checkpoint) as the port's state: an ``Encoder`` state dict of f32
    CPU tensors."""
    return {k: torch.from_numpy(np.array(v, dtype=np.float32)) for k, v in flatten_tree(tree).items()}


def init_params(seed: int, cfg: EncoderConfig) -> dict[str, torch.Tensor]:
    """The seed init of the JAX package (``init_params(PRNGKey(seed))``) as
    the port's state."""
    return params_from_numpy(init_tree(seed, cfg))


# -- the model ----------------------------------------------------------------


class _Norm(nn.Module):
    def __init__(self, d: int) -> None:
        super().__init__()
        self.scale = nn.Parameter(torch.ones(d), requires_grad=False)
        self.bias = nn.Parameter(torch.zeros(d), requires_grad=False)


def _param(*shape: int) -> nn.Parameter:
    return nn.Parameter(torch.zeros(shape), requires_grad=False)


class _Layer(nn.Module):
    def __init__(self, cfg: EncoderConfig) -> None:
        super().__init__()
        d, f = cfg.d_model, cfg.d_ff
        self.ln1, self.ln2 = _Norm(d), _Norm(d)
        self.wq, self.wk, self.wv, self.wo = (_param(d, d) for _ in range(4))
        self.w1, self.b1 = _param(d, f), _param(f)
        self.w2, self.b2 = _param(f, d), _param(d)


class _Rsqrt(torch.autograd.Function):
    """``lax.rsqrt`` with JAX's derivative, g * (-0.5 * (ans / x)), each
    operation rounded in the operand's dtype (PyTorch's own rsqrt backward
    forms ans^3, which rounds otherwise in bf16)."""

    @staticmethod
    def forward(ctx, x):
        ans = torch.rsqrt(x)
        ctx.save_for_backward(x, ans)
        return ans

    @staticmethod
    def backward(ctx, g):
        x, ans = ctx.saved_tensors
        return g * (-0.5 * (ans / x))


def _layer_norm(x, scale, bias, eps=1e-6):
    """jnp.mean / jnp.var of a bf16 array compute in f32 and round their
    result back; the population variance (``correction=0``). Each takes its
    own f32 copy of x, as each jnp call converts it, so their gradients
    round to bf16 apart, as JAX's transposes round them."""
    mean = x.float().mean(dim=-1, keepdim=True).to(x.dtype)
    var = x.float().var(dim=-1, keepdim=True, correction=0).to(x.dtype)
    return (x - mean) * _Rsqrt.apply(var + eps) * scale + bias


def _mm(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """a @ w with compute-dtype operands summed in f32: the operands' f32
    upcast is exact, and the f32 product runs with TF32 off."""
    return torch.matmul(a.float(), w.float())


# the leaves of one layer, under their names in the state dict
LAYER_KEYS = ("ln1.scale", "ln1.bias", "ln2.scale", "ln2.bias", "wq", "wk", "wv", "wo",
              "w1", "b1", "w2", "b2")


def _attention(x, layer, mask, cfg: EncoderConfig):
    b, l, _ = x.shape
    h, hd = cfg.n_heads, cfg.head_dim
    dtype = x.dtype
    q, k, v = (_mm(x, layer[w]).reshape(b, l, h, hd) for w in ("wq", "wk", "wv"))
    logits = torch.einsum("blhe,bmhe->bhlm", q, k) / np.float32(np.sqrt(hd))
    logits = torch.where(mask[:, None, None, :], logits,
                         torch.tensor(-1e30, dtype=torch.float32, device=x.device))
    weights = torch.softmax(logits, dim=-1).to(dtype).float()
    out = torch.einsum("bhlm,bmhe->blhe", weights, v)
    return _mm(out.reshape(b, l, h * hd).to(dtype), layer["wo"])


def encode(params, token_ids: torch.Tensor, cfg: EncoderConfig) -> torch.Tensor:
    """The JAX package's ``forward(params, ids, cfg)`` on the state dict's
    tensors (``params``: a mapping of its keys), differentiable: the casts
    sit where the JAX graph puts them, so autograd rounds the gradients at
    the same places as JAX's transposes. The token gather is
    ``F.embedding``, whose backward on the card sums by sorted index (no
    atomics)."""
    from omni_recall_tpu_torch.ops.scorer import _no_tf32

    dtype = getattr(torch, cfg.compute_dtype)
    token_ids = token_ids.to(params["tok_embed"].device).long()
    mask = token_ids > 0
    with _no_tf32():
        x = (torch.nn.functional.embedding(token_ids, params["tok_embed"])
             + params["pos_embed"][None, : token_ids.shape[1]])
        x = x.to(dtype)
        for i in range(cfg.n_layers):
            layer = {name: params[f"layers.{i}.{name}"].to(dtype) for name in LAYER_KEYS}
            h = _layer_norm(x, layer["ln1.scale"], layer["ln1.bias"])
            x = x + _attention(h, layer, mask, cfg).to(dtype)
            h = _layer_norm(x, layer["ln2.scale"], layer["ln2.bias"])
            ff = _mm(h, layer["w1"]) + layer["b1"]
            ff = torch.nn.functional.gelu(ff, approximate="tanh").to(dtype)
            ff = _mm(ff, layer["w2"]) + layer["b2"]
            x = x + ff.to(dtype)
        x = _layer_norm(x.float(), params["final_ln.scale"], params["final_ln.bias"])
        maskf = mask.to(torch.float32)
        denom = torch.clamp(mask.sum(dim=1, keepdim=True), min=1)
        pooled = (x * maskf[:, :, None]).sum(dim=1) / denom  # mean over real tokens
        z = pooled @ params["out_proj"]
        return z / torch.clamp(torch.linalg.norm(z, dim=-1, keepdim=True), min=1e-6)


class Encoder(nn.Module):
    """token_ids int[B, L] -> L2-normalized embeddings f32[B, out_dim]."""

    def __init__(self, cfg: EncoderConfig) -> None:
        super().__init__()
        self.cfg = cfg
        self.tok_embed = _param(cfg.vocab_size, cfg.d_model)
        self.pos_embed = _param(cfg.max_len, cfg.d_model)
        self.out_proj = _param(cfg.d_model, cfg.out_dim)
        self.final_ln = _Norm(cfg.d_model)
        self.layers = nn.ModuleList(_Layer(cfg) for _ in range(cfg.n_layers))

    @classmethod
    def from_state(cls, state: dict[str, torch.Tensor], cfg: EncoderConfig,
                   device: str | torch.device = "cuda") -> "Encoder":
        from omni_recall_tpu_torch.device import resolve_device

        model = cls(cfg)
        model.load_state_dict({k: torch.as_tensor(v, dtype=torch.float32) for k, v in state.items()})
        return model.to(resolve_device(device)).eval()

    @torch.no_grad()
    def forward(self, token_ids: torch.Tensor) -> torch.Tensor:
        return encode(dict(self.named_parameters()), token_ids, self.cfg)


def forward(params: dict[str, torch.Tensor], token_ids, cfg: EncoderConfig,
            device: str | torch.device = "cuda") -> torch.Tensor:
    """Functional form of the JAX package's ``forward(params, ids, cfg)``,
    on ``device``."""
    return Encoder.from_state(params, cfg, device)(torch.as_tensor(np.asarray(token_ids)))


# -- training -----------------------------------------------------------------


def info_nce_loss(params, query_ids, chunk_ids, cfg: EncoderConfig,
                  temperature: float = 0.05) -> torch.Tensor:
    """Symmetric in-batch-negatives contrastive loss (JAX ``info_nce_loss``)."""
    from omni_recall_tpu_torch.ops.scorer import _no_tf32

    zq = encode(params, query_ids, cfg)
    zc = encode(params, chunk_ids, cfg)
    with _no_tf32():
        logits = (zq @ zc.T) / temperature
    loss_qc = -torch.log_softmax(logits, dim=1).diagonal().mean()
    loss_cq = -torch.log_softmax(logits, dim=0).diagonal().mean()
    return 0.5 * (loss_qc + loss_cq)


def trainable(params, device: str | torch.device = "cuda") -> dict[str, torch.Tensor]:
    """f32 master copies of a state dict on ``device``, with ``requires_grad``."""
    from omni_recall_tpu_torch.device import resolve_device

    dev = resolve_device(device)
    return {k: torch.as_tensor(v, dtype=torch.float32).detach().to(dev).clone()
            .requires_grad_(True) for k, v in params.items()}


def value_and_grad(loss_fn, params: dict[str, torch.Tensor], *args):
    """(loss, {key: grad}) of ``loss_fn(params, *args)`` (``jax.value_and_grad``);
    the backward runs with TF32 off, as the forward does."""
    from omni_recall_tpu_torch.ops.scorer import _no_tf32

    keys = list(params)
    loss = loss_fn(params, *args)
    with _no_tf32():
        grads = torch.autograd.grad(loss, [params[k] for k in keys])
    return loss.detach(), dict(zip(keys, grads))


class AdamW:
    """``optax.adamw`` written in torch, its defaults: b1 0.9, b2 0.999, eps
    1e-8 outside the square root, weight decay 1e-4 on every leaf, the
    bias corrections of f32 ``1 - b ** count``, and optax's order of
    operations (the moments as ``(1 - b) * g + b * m``, the decay added to
    the scaled update, then the step scaled by -lr). PyTorch's own
    ``AdamW`` applies the decay first and defaults to 1e-2."""

    def __init__(self, learning_rate: float = 1e-3, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8, weight_decay: float = 1e-4) -> None:
        self.learning_rate, self.b1, self.b2 = learning_rate, b1, b2
        self.eps, self.weight_decay = eps, weight_decay

    def init(self, params: dict[str, torch.Tensor]) -> dict:
        zeros = {k: torch.zeros_like(v, dtype=torch.float32).detach() for k, v in params.items()}
        return {"count": 0, "mu": zeros, "nu": {k: v.clone() for k, v in zeros.items()}}

    @torch.no_grad()
    def update(self, grads: dict, state: dict, params: dict) -> tuple[dict, dict]:
        """(updates, new state), as ``optimizer.update(grads, state, params)``.
        Each operation runs over every leaf at once (``torch._foreach_*``:
        a few launches a step on the card, not a dozen a leaf); each element
        is rounded as the per-leaf expression would round it."""
        keys = list(grads)
        g = [grads[k] for k in keys]
        b1, b2 = np.float32(self.b1), np.float32(self.b2)
        count = state["count"] + 1
        c1 = float(np.float32(1.0) - b1 ** np.float32(count))
        c2 = float(np.float32(1.0) - b2 ** np.float32(count))
        fe = torch
        mu = fe._foreach_add(fe._foreach_mul(g, 1.0 - self.b1),
                             fe._foreach_mul([state["mu"][k] for k in keys], self.b1))
        nu = fe._foreach_add(fe._foreach_mul(fe._foreach_mul(g, g), 1.0 - self.b2),
                             fe._foreach_mul([state["nu"][k] for k in keys], self.b2))
        denom = fe._foreach_add(fe._foreach_sqrt(fe._foreach_div(nu, c2)), self.eps)
        u = fe._foreach_div(fe._foreach_div(mu, c1), denom)
        u = fe._foreach_add(u, fe._foreach_mul([params[k].detach() for k in keys],
                                               self.weight_decay))
        updates = fe._foreach_mul(u, -self.learning_rate)
        return dict(zip(keys, updates)), {"count": count, "mu": dict(zip(keys, mu)),
                                          "nu": dict(zip(keys, nu))}


@torch.no_grad()
def apply_updates(params: dict[str, torch.Tensor], updates: dict) -> dict[str, torch.Tensor]:
    """``optax.apply_updates``, in place on the master copies."""
    keys = list(updates)
    torch._foreach_add_([params[k] for k in keys], [updates[k] for k in keys])
    return params


def sgd_train_step(params, query_ids, chunk_ids, cfg: EncoderConfig, lr: float = 1e-3):
    """One plain SGD step (JAX ``sgd_train_step``): (params, loss)."""
    loss, grads = value_and_grad(info_nce_loss, params, query_ids, chunk_ids, cfg)
    with torch.no_grad():
        for k, g in grads.items():
            params[k].sub_(lr * g)
    return params, loss


def make_train_step(cfg: EncoderConfig, optimizer: AdamW | None = None):
    """(optimizer, train_step) with ``train_step(params, opt_state,
    query_ids, chunk_ids) -> (params, opt_state, loss)`` (JAX
    ``make_train_step``; AdamW(1e-3) by default). ``params`` are the
    master copies of ``trainable``, updated in place."""
    optimizer = optimizer or AdamW(1e-3)

    def train_step(params, opt_state, query_ids, chunk_ids):
        loss, grads = value_and_grad(info_nce_loss, params, query_ids, chunk_ids, cfg)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        return apply_updates(params, updates), opt_state, loss

    return optimizer, train_step


def bucket_ids(ids: np.ndarray, floor: int = 16) -> np.ndarray:
    """Token ids [B, max_len] cut to the next power of two >= the longest
    row (at least ``floor``, at most max_len): the padding positions are
    masked out of attention and pooling, so the loss and its gradients do
    not depend on the cut."""
    n_tok = int((ids > 0).sum(axis=1).max()) if ids.size else 0
    width = floor
    while width < min(max(n_tok, 1), ids.shape[1]):
        width *= 2
    return ids[:, : min(width, ids.shape[1])]


def tree_from_state(state: dict) -> dict:
    """A state dict as the JAX package's parameter pytree (nested dicts and a
    ``layers`` list of numpy f32 leaves): the layout ``jax.tree`` functions
    and the JAX ``forward`` take."""
    tree: dict = {}
    for key, v in state.items():
        parts = key.split(".")
        node = tree
        for part, nxt in zip(parts[:-1], parts[1:]):
            default = [] if nxt.isdigit() else {}
            if part.isdigit():
                while len(node) <= int(part):
                    node.append(default)
                node = node[int(part)]
            else:
                node = node.setdefault(part, default)
        leaf = v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
        node[parts[-1]] = np.array(leaf, dtype=np.float32)
    return tree


# -- checkpointing ------------------------------------------------------------


def save_params(path: str, params, cfg: EncoderConfig) -> None:
    """Persist params + config as one .npz with the JAX package's keys
    (flattened pytree paths and ``__config__``), written through a file
    object so the exact path round-trips. ``params``: an ``Encoder``, its
    state dict, or a pytree of arrays."""
    if isinstance(params, nn.Module):
        params = params.state_dict()
    flat = flatten_tree(params)
    flat["__config__"] = np.frombuffer(json.dumps(cfg.__dict__).encode("utf-8"), dtype=np.uint8)
    with open(path, "wb") as fh:
        np.savez(fh, **flat)


def load_checkpoint(path: str, cfg_cls):
    """Inverse of save_params for any config dataclass sharing the .npz
    scheme: (state dict of f32 CPU tensors, config)."""
    with np.load(path) as data:
        cfg = cfg_cls(**json.loads(bytes(data["__config__"].tobytes()).decode("utf-8")))
        state = {k: torch.from_numpy(np.array(data[k], dtype=np.float32))
                 for k in data.files if k != "__config__"}
    return state, cfg


def load_params(path: str) -> tuple[dict[str, torch.Tensor], EncoderConfig]:
    return load_checkpoint(path, EncoderConfig)
