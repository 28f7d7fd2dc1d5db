"""The port's chat decoder (omni_recall_tpu_torch/models/decoder.py) against
the JAX package's on the CPU, at a small size (d_model 32, 2 layers, 2
heads, max_len 160).

The same weights (JAX's seed-7 init, and the port's numpy copy of it) and
the same prompts go through both. Teacher-forced logits of ``forward``,
``prefill``, ``prefill_chunked`` and ``decode_step``: within 1e-5 in f32
compute; in bf16 within 2e-2 of the logits' largest magnitude (JAX's own
jitted and eager bf16 decode steps stand 0.8% apart at this size). Greedy
``generate`` equals JAX's in f32; in bf16, JAX's tokens are fed back
through the port's decode steps and each must be the port's argmax unless
the port's top-2 gap is within that tolerance. Sampled ``generate``
reproduces JAX's ``split`` / ``categorical`` streams. Checkpoints cross
both ways; ``lp + n_steps > max_len`` raises; training through
``lm_loss`` follows JAX's losses.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from omni_recall_tpu.models import decoder as jdec
from omni_recall_tpu_torch.models import decoder as tdec
from omni_recall_tpu_torch.models import encoder as tenc

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

SMALL = dict(d_model=32, n_layers=2, n_heads=2, d_ff=64, max_len=160)
PROMPTS = ["hello recall world", "the quick brown fox jumps over", "tpu", "Ünïcödé?"]
BF16_REL = 2e-2


def _cfgs(dtype):
    return (jdec.DecoderConfig(**SMALL, compute_dtype=dtype),
            tdec.DecoderConfig(**SMALL, compute_dtype=dtype))


@pytest.fixture(scope="module")
def jparams():
    return jdec.init_params(jax.random.PRNGKey(7), jdec.DecoderConfig(**SMALL))


def _tparams(jp):
    return tenc.params_from_numpy(jax.tree.map(np.asarray, jp))


def _close(got, want, dtype):
    want = np.asarray(want, dtype=np.float32)
    err = np.abs(np.asarray(got, dtype=np.float32) - want).max()
    tol = 1e-5 if dtype == "float32" else BF16_REL * np.abs(want).max()
    return err <= tol, err


def _prompt(lp=32):
    return tdec.pad_left_batch([tdec.encode_text(p) for p in PROMPTS], lp)


def test_tokenizer_and_padding_match_jax():
    for text in PROMPTS + ["", "x" * 300]:
        assert tdec.encode_text(text) == jdec.encode_text(text)
        assert tdec.encode_text(text, max_bytes=7) == jdec.encode_text(text, max_bytes=7)
    assert tdec.encode_text("abc", max_bytes=0) == jdec.encode_text("abc", max_bytes=0)
    toks = [tdec.encode_text(p) for p in PROMPTS]
    assert np.array_equal(tdec.pad_left_batch(toks, 12), jdec.pad_left_batch(toks, 12))
    assert tdec.decode_tokens(toks[3] + [tdec.EOS, 0, 300]) == jdec.decode_tokens(
        toks[3] + [tdec.EOS, 0, 300])


def test_seed_init_matches_jax(jparams):
    mine = tdec.init_params(7, tdec.DecoderConfig(**SMALL))
    want = tenc.flatten_tree(jax.tree.map(np.asarray, jparams))
    assert set(mine) == set(want)
    for k, v in want.items():
        assert np.abs(mine[k].numpy() - v).max() <= 1e-6, k


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_teacher_forced_logits_match_jax(jparams, dtype):
    jcfg, tcfg = _cfgs(dtype)
    tp = _tparams(jparams)
    prompt = _prompt()
    ok, err = _close(tdec.forward(tp, prompt, tcfg).numpy(),
                     jdec.forward(jparams, jnp.asarray(prompt), jcfg), dtype)
    assert ok, ("forward", err)
    jl, jcache = jdec.prefill(jparams, jnp.asarray(prompt), jcfg)
    tl, tcache = tdec.prefill(tp, prompt, tcfg)
    ok, err = _close(tl.numpy(), jl, dtype)
    assert ok, ("prefill", err)
    for li in range(tcfg.n_layers):
        for name in ("k", "v"):
            ok, err = _close(tcache[li][name].float().numpy(),
                             np.asarray(jcache[li][name]).astype(np.float32), dtype)
            assert ok, ("cache", li, name, err)
    jc, _ = jdec.prefill_chunked(jparams, prompt, jcfg, 8)
    tc, _ = tdec.prefill_chunked(tp, prompt, tcfg, 8)
    ok, err = _close(tc.numpy(), jc, dtype)
    assert ok, ("prefill_chunked", err)
    # decode steps fed the same tokens (JAX's cache into JAX, the port's
    # into the port), at the generate() window and at the full window
    kv = np.concatenate([prompt != 0, np.ones((len(PROMPTS), tcfg.max_len - 32), bool)], 1)
    for step, tok in enumerate(([5, 6, 7, 8], [40, 2, 100, 9], [3, 3, 3, 3])):
        tok = np.asarray(tok, np.int32)
        for attend in (128, None):
            jd, jcache2 = jdec.decode_step(jparams, jcache, jnp.asarray(tok), 32 + step, jcfg,
                                           jnp.asarray(kv), attend_len=attend)
            td, tcache2 = tdec.decode_step(tp, tcache, tok, 32 + step, tcfg,
                                           torch.from_numpy(kv), attend_len=attend)
            ok, err = _close(td.numpy(), jd, dtype)
            assert ok, ("decode_step", step, attend, err)
        jcache, tcache = jcache2, tcache2


def test_greedy_generate_equals_jax_in_f32(jparams):
    jcfg, tcfg = _cfgs("float32")
    prompt = _prompt()
    want = np.asarray(jdec.generate(jparams, jnp.asarray(prompt), jcfg, 24,
                                    jax.random.PRNGKey(0)))
    got = tdec.generate(_tparams(jparams), prompt, tcfg, 24, 0).numpy()
    assert np.array_equal(got, want)


def test_greedy_generate_follows_jax_in_bf16_where_the_gap_is_clear(jparams):
    """JAX's greedy tokens, fed back through the port's decode steps: each
    is the port's argmax unless the port's top-2 gap is within the
    tolerance (a near-tie may flip)."""
    jcfg, tcfg = _cfgs("bfloat16")
    prompt = _prompt()
    steps = 24
    want = np.asarray(jdec.generate(jparams, jnp.asarray(prompt), jcfg, steps,
                                    jax.random.PRNGKey(0)))
    w = tdec.Weights(_tparams(jparams), tcfg)
    logits, cache = tdec.prefill(w, prompt, tcfg)
    emit = tdec.emit_mask(tcfg, "cpu")
    kv = torch.from_numpy(np.concatenate(
        [prompt != 0, np.ones((len(PROMPTS), tcfg.max_len - 32), bool)], 1))
    done = np.zeros(len(PROMPTS), bool)
    al = tdec.attend_window(tcfg, 32, steps)
    agreed = 0
    for step in range(steps):
        masked = torch.where(emit[None], logits, torch.tensor(-1e30)).numpy()
        for row in range(len(PROMPTS)):
            if done[row]:
                assert want[row, step] == tdec.PAD
                continue
            top2 = np.sort(masked[row])[-2:]
            gap = top2[1] - top2[0]
            if masked[row].argmax() == want[row, step]:
                agreed += 1
            else:
                assert gap <= BF16_REL * np.abs(masked[row]).max(), (step, row, gap)
        tok = want[:, step]
        done |= tok == tdec.EOS
        kv[:, 32 + step] &= torch.from_numpy(tok != tdec.PAD)
        logits, cache = tdec.decode_step(w, cache, tok, 32 + step, tcfg, kv, attend_len=al)
    assert agreed >= 0.9 * int((want != tdec.PAD).sum())


def test_sampled_generate_reproduces_jax(jparams):
    jcfg, tcfg = _cfgs("float32")
    prompt = _prompt()
    for seed in (3, 11):
        want = np.asarray(jdec.generate(jparams, jnp.asarray(prompt), jcfg, 20,
                                        jax.random.PRNGKey(seed), temperature=0.8))
        got = tdec.generate(_tparams(jparams), prompt, tcfg, 20, seed, temperature=0.8)
        assert np.array_equal(got.numpy(), want)


def test_keys_and_gumbel_match_jax():
    keys = np.stack([np.asarray(jax.random.PRNGKey(s)) for s in (0, 1, 99)])
    nxt, sub = tdec.split_keys(torch.from_numpy(keys.astype(np.int64)))
    for i, s in enumerate((0, 1, 99)):
        want = np.asarray(jax.random.split(jax.random.PRNGKey(s)))
        assert np.array_equal(nxt[i].numpy(), want[0]) and np.array_equal(sub[i].numpy(),
                                                                            want[1])
        g = np.asarray(jax.random.gumbel(jax.random.PRNGKey(s), (384,), jnp.float32))
        mine = tdec.gumbel(torch.from_numpy(keys[i:i + 1].astype(np.int64)), 384)[0].numpy()
        assert np.abs(mine - g).max() <= 4 * np.spacing(np.abs(g)).max()


def test_generate_pads_after_eos_and_checks_the_window(jparams):
    tcfg = _cfgs("float32")[1]
    tp = _tparams(jparams)
    head = torch.zeros_like(tp["lm_head"])
    head[:, tdec.EOS] = 1.0
    forced = {**tp, "lm_head": head, "final_ln.bias": torch.ones(tcfg.d_model)}
    ids = tdec.pad_left_batch([tdec.encode_text("x")], 16)
    out = tdec.generate(forced, ids, tcfg, 5).numpy()
    assert out[0, 0] == tdec.EOS and (out[0, 1:] == tdec.PAD).all()
    with pytest.raises(ValueError, match="max_len"):
        tdec.generate(tp, tdec.pad_left_batch([[1, 5]], 150), tcfg, 11)
    with pytest.raises(ValueError, match="max_len"):
        jdec.generate(jparams, jnp.asarray(tdec.pad_left_batch([[1, 5]], 150)),
                      _cfgs("float32")[0], 11, jax.random.PRNGKey(0))


def test_full_window_equals_attend_window(jparams):
    tcfg = _cfgs("float32")[1]
    tp = _tparams(jparams)
    prompt = _prompt()
    a = tdec.generate(tp, prompt, tcfg, 16)
    b = tdec.generate(tp, prompt, tcfg, 16, full_window=True)
    assert torch.equal(a, b)


def test_checkpoints_cross_both_ways(jparams, tmp_path):
    jcfg, tcfg = _cfgs("bfloat16")
    jpath, tpath = str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")
    jdec.save_params(jpath, jparams, jcfg)
    state, cfg = tdec.load_params(jpath)
    assert cfg == tcfg
    want = tenc.flatten_tree(jax.tree.map(np.asarray, jparams))
    assert all(np.array_equal(state[k].numpy(), v) for k, v in want.items())
    tdec.save_params(tpath, state, cfg)
    back, bcfg = jdec.load_params(tpath)
    assert bcfg == jcfg
    assert all(np.array_equal(a, b) for a, b in zip(
        jax.tree.leaves(jax.tree.map(np.asarray, back)),
        jax.tree.leaves(jax.tree.map(np.asarray, jparams))))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lm_loss_and_training_follow_jax(jparams, dtype):
    jcfg, tcfg = _cfgs(dtype)
    ids = tdec.pad_left_batch([tdec.encode_text("the index lives in hbm. " * 3),
                               tdec.encode_text("short one")], 96)
    tol = 1e-5 if dtype == "float32" else 2e-3
    jl = float(jdec.lm_loss(jparams, jnp.asarray(ids), jcfg))
    tl = float(tdec.lm_loss(_tparams(jparams), ids, tcfg))
    assert abs(tl - jl) <= tol * abs(jl)
    # five AdamW steps: JAX's losses step by step
    opt, step = jdec.make_train_step(jcfg, optax.adamw(3e-4))
    jp, js = jparams, opt.init(jparams)
    step = jax.jit(step)
    topt, tstep = tdec.make_train_step(tcfg)
    tp = tenc.trainable(_tparams(jparams), "cpu")
    ts = topt.init(tp)
    for _ in range(5):
        jp, js, jloss = step(jp, js, jnp.asarray(ids))
        tp, ts, tloss = tstep(tp, ts, torch.from_numpy(ids))
        assert abs(float(tloss) - float(jloss)) <= 1e-3 * abs(float(jloss))


def test_training_reduces_loss_and_memorizes():
    cfg = tdec.DecoderConfig(**{**SMALL, "max_len": 96})
    ids = torch.from_numpy(tdec.pad_left_batch(
        [tdec.encode_text("the index lives in hbm. " * 3)], cfg.max_len))
    params = tenc.trainable(tdec.init_params(1, cfg), "cpu")
    optimizer, train_step = tdec.make_train_step(cfg)
    state = optimizer.init(params)
    losses = []
    for _ in range(60):
        params, state, loss = train_step(params, state, ids)
        losses.append(float(loss))
    assert losses[-1] < losses[0] * 0.5, losses[::20]


def test_decoder_needs_cuda_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tdec.DecoderConfig(**SMALL)
    with pytest.raises(RuntimeError, match="CUDA"):
        tdec.serving_weights(tdec.init_params(0, cfg), cfg)
    assert tdec.serving_weights(tdec.init_params(0, cfg), cfg, "cpu").device.type == "cpu"
