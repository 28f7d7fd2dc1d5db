"""The port's encoder training (omni_recall_tpu_torch/models/encoder.py
``info_nce_loss``, ``AdamW``, ``make_train_step``; models/finetune.py)
against the JAX package's on the CPU, at a small size (d_model 64, 2
layers, vocab 4096, out 64).

Tolerances: in f32 compute the loss within 1e-5 relative and each gradient
leaf's max abs difference within 1e-4 of that leaf's max abs; in bf16
compute the loss within 2e-3 relative and each leaf's ||diff|| / ||grad||
at most 2e-2 (bf16 noise: the layer-norm parameters' gradients are sums of
bf16 cotangents that mostly cancel, and JAX's own bf16 gradients stand
2-3% from its f32 ones at this size); one AdamW step within 1e-6 relative
of ``optax.adamw`` on every leaf; a 20-step fine-tune's losses within 1e-3
relative of JAX's at every step.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from omni_recall_tpu.models import encoder as jenc
from omni_recall_tpu.models import finetune as jft
from omni_recall_tpu_torch.models import encoder as tenc
from omni_recall_tpu_torch.models import finetune as tft

@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """The suite runs in parallel worker processes, and these tensors are
    small: one intra-op thread a process (also in the threads the batcher
    and the ingestion start) keeps the workers from oversubscribing the
    cores (without it these files ran 20-75 times slower there)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

SMALL = dict(vocab_size=4096, d_model=64, n_layers=2, n_heads=4, d_ff=128, max_len=32,
             out_dim=64)
WORDS = [f"w{i}" for i in range(300)]


def _cfgs(dtype="float32"):
    return (jenc.EncoderConfig(**SMALL, compute_dtype=dtype),
            tenc.EncoderConfig(**SMALL, compute_dtype=dtype))


def _batch(seed: int, n: int = 16):
    rng = np.random.default_rng(seed)
    qs = [" ".join(rng.choice(WORDS, rng.integers(2, 6))) for _ in range(n)]
    cs = [" ".join(rng.choice(WORDS, rng.integers(5, 20))) for _ in range(n)]
    return qs, cs


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _jax_and_port_grads(dtype, seed=0):
    jcfg, tcfg = _cfgs(dtype)
    params = jenc.init_params(jax.random.PRNGKey(0), jcfg)
    qs, cs = _batch(seed)
    qi, ci = jenc.tokenize_batch(qs, jcfg), jenc.tokenize_batch(cs, jcfg)
    jl, jg = jax.value_and_grad(jenc.info_nce_loss)(params, jnp.asarray(qi), jnp.asarray(ci),
                                                     jcfg)
    tp = tenc.trainable(tenc.params_from_numpy(_np_tree(params)), "cpu")
    tl, tg = tenc.value_and_grad(tenc.info_nce_loss, tp, torch.from_numpy(qi),
                                 torch.from_numpy(ci), tcfg)
    return float(jl), tenc.flatten_tree(_np_tree(jg)), float(tl), tg


def test_loss_and_gradients_match_jax_in_f32():
    jl, jg, tl, tg = _jax_and_port_grads("float32")
    assert abs(tl - jl) <= 1e-5 * abs(jl)
    assert set(jg) == set(tg)
    for k, want in jg.items():
        got = tg[k].numpy()
        assert got.shape == want.shape, k
        assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max(), k


def test_loss_and_gradients_match_jax_in_bf16():
    jl, jg, tl, tg = _jax_and_port_grads("bfloat16")
    assert abs(tl - jl) <= 2e-3 * abs(jl)
    for k, want in jg.items():
        diff = np.linalg.norm(tg[k].numpy() - want)
        assert diff <= 2e-2 * np.linalg.norm(want), (k, diff / np.linalg.norm(want))


def test_one_adamw_step_matches_optax():
    rng = np.random.default_rng(3)
    params = {"a": rng.standard_normal((64, 32)).astype(np.float32),
              "b": rng.standard_normal(32).astype(np.float32)}
    grads = [{k: (rng.standard_normal(v.shape) * 10.0 ** rng.integers(-6, 1)).astype(np.float32)
              for k, v in params.items()} for _ in range(3)]
    opt = optax.adamw(3e-4)
    jp, js = dict(params), opt.init(params)
    topt = tenc.AdamW(3e-4)
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    ts = topt.init(tp)
    for g in grads:  # three steps: the bias corrections move with the count
        up, js = opt.update(g, js, jp)
        jp = optax.apply_updates(jp, up)
        tup, ts = topt.update({k: torch.from_numpy(v) for k, v in g.items()}, ts, tp)
        tp = tenc.apply_updates(tp, tup)
        for k in params:
            want = np.asarray(jp[k])
            assert np.abs(tp[k].numpy() - want).max() <= 1e-6 * np.abs(want).max(), k


def test_adamw_defaults_are_optax_adamw():
    opt = tenc.AdamW()
    assert (opt.b1, opt.b2, opt.eps, opt.weight_decay) == (0.9, 0.999, 1e-8, 1e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bucketed_batch_equals_max_len_padded(dtype):
    """Training on ids cut to a power-of-two width gives the max_len-padded
    loss and gradients (padding is masked), and JAX's padded step."""
    jcfg, tcfg = _cfgs(dtype)
    params = tenc.init_params(0, tcfg)
    qs, cs = _batch(1)
    qi, ci = tenc.tokenize_batch(qs, tcfg), tenc.tokenize_batch(cs, tcfg)
    assert tenc.bucket_ids(qi).shape[1] == 16 and tenc.bucket_ids(ci).shape[1] == 32
    short = tenc.bucket_ids(tenc.tokenize_batch(["a b", "c"], tcfg))
    assert short.shape == (2, 16)
    tp = tenc.trainable(params, "cpu")
    pl, pg = tenc.value_and_grad(tenc.info_nce_loss, tp, torch.from_numpy(qi),
                                 torch.from_numpy(ci), tcfg)
    bl, bg = tenc.value_and_grad(tenc.info_nce_loss, tp, torch.from_numpy(tenc.bucket_ids(qi)),
                                 torch.from_numpy(tenc.bucket_ids(ci)), tcfg)
    jl = float(jenc.info_nce_loss(tenc.tree_from_state(params), jnp.asarray(qi),
                                  jnp.asarray(ci), jcfg))
    tol = 1e-5 if dtype == "float32" else 2e-3
    assert abs(float(bl) - float(pl)) <= tol * abs(float(pl))
    assert abs(float(bl) - jl) <= tol * abs(jl)
    for k in pg:
        scale = float(pg[k].abs().max())
        assert float((bg[k] - pg[k]).abs().max()) <= 1e-4 * max(scale, 1e-30), k


def _jax_finetune_record(contents, cfg, steps, seed, batch, monkeypatch):
    """Run the JAX package's ``inverse_cloze_finetune``, recording each
    step's token ids and loss."""
    seen = []
    real = jenc.make_train_step

    def recording(cfg_, optimizer=None):
        optimizer, step = real(cfg_, optimizer)

        def train_step(params, opt_state, q_ids, c_ids):
            params, opt_state, loss = step(params, opt_state, q_ids, c_ids)
            jax.debug.callback(lambda q, c, l: seen.append((np.asarray(q), np.asarray(c),
                                                            float(l))),
                               q_ids, c_ids, loss, ordered=True)
            return params, opt_state, loss

        return optimizer, train_step

    monkeypatch.setattr(jenc, "make_train_step", recording)
    params = jft.inverse_cloze_finetune(contents, cfg, steps=steps, seed=seed, batch=batch)
    jax.effects_barrier()
    return params, seen


def _corpus(n=40):
    rng = np.random.default_rng(11)
    return [" ".join(rng.choice(WORDS, rng.integers(4, 24))) for _ in range(n)]


def test_pair_maker_draws_equal_jax(monkeypatch):
    jcfg, tcfg = _cfgs()
    contents = _corpus()
    _, seen = _jax_finetune_record(contents, jcfg, 3, 5, 8, monkeypatch)
    make_pair = tft.pair_maker(5)
    nrng = np.random.default_rng(5)
    for q_ids, c_ids, _ in seen:
        idx = nrng.integers(0, len(contents), size=8)
        pairs = [make_pair(contents[i]) for i in idx]
        assert np.array_equal(tenc.tokenize_batch([p[0] for p in pairs], tcfg), q_ids)
        assert np.array_equal(tenc.tokenize_batch([p[1] for p in pairs], tcfg), c_ids)


def test_twenty_step_finetune_tracks_jax(monkeypatch):
    jcfg, tcfg = _cfgs()
    contents = _corpus()
    jparams, seen = _jax_finetune_record(contents, jcfg, 20, 0, 16, monkeypatch)
    losses = []
    state = tft.inverse_cloze_finetune(contents, tcfg, steps=20, seed=0, batch=16,
                                       device="cpu",
                                       on_step=lambda i, loss: losses.append(float(loss)))
    want = [s[2] for s in seen]
    assert len(losses) == len(want) == 20
    for i, (a, b) in enumerate(zip(losses, want)):
        assert abs(a - b) <= 1e-3 * abs(b), (i, a, b)
    assert losses[-1] < losses[0]
    # the trained weights embed as JAX's trained weights do
    ids = jenc.tokenize_batch(contents[:8], jcfg)
    jz = np.asarray(jenc.forward(jparams, jnp.asarray(ids), jcfg))
    tz = tenc.Encoder.from_state(state, tcfg, "cpu")(torch.from_numpy(ids)).numpy()
    assert np.abs(jz - tz).max() <= 1e-3


def test_state_dict_and_pytree_round_trip():
    jcfg, tcfg = _cfgs()
    tree = _np_tree(jenc.init_params(jax.random.PRNGKey(2), jcfg))
    state = tenc.params_from_numpy(tree)
    back = tenc.tree_from_state(state)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        assert a.dtype == np.float32 and np.array_equal(a, b)
    again = tenc.params_from_numpy(back)
    assert set(again) == set(state)
    assert all(torch.equal(again[k], state[k]) for k in state)
    # trained master copies (on the device, requires_grad) convert too
    master = tenc.trainable(state, "cpu")
    assert all(np.array_equal(a, b) for a, b in zip(
        jax.tree.leaves(tenc.tree_from_state(master)), jax.tree.leaves(tree)))


def test_finetune_refuses_an_empty_corpus():
    with pytest.raises(ValueError):
        tft.inverse_cloze_finetune([], _cfgs()[1], steps=1, device="cpu")


def test_finetune_needs_cuda_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tft.inverse_cloze_finetune(["a b c d"], _cfgs()[1], steps=1)
