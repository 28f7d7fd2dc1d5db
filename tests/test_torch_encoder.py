"""The port's local encoder (omni_recall_tpu_torch/models/encoder.py) and its
embedding client against the JAX package's on the CPU.

The same seeded inputs go through both: tokenization bit for bit; the
seed-0 init within 1e-4 (the port reproduces jax.random in numpy); the
forward in f32 compute within 1e-5 max abs, and in bf16 within twice the
JAX package's own bf16-vs-f32 gap at the same config; checkpoints written
by either package load in the other; the client's embed, embed_batch and
embed_device agree with each other and with the JAX client.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omni_recall_tpu.ingest import embedding as jemb
from omni_recall_tpu.models import encoder as jenc
from omni_recall_tpu_torch.ingest import embedding as temb
from omni_recall_tpu_torch.models import encoder as tenc

SMALL = dict(vocab_size=512, d_model=64, n_layers=2, n_heads=4, d_ff=128, max_len=16,
             out_dim=48)
TEXTS = ["hello world", "tpu kernels go brr", "", "topic c12x note r3 " * 2, "a",
         "Ünïcödé wörds and MIXED case", "   ", "x " * 40]


@pytest.fixture(scope="module")
def small():
    jcfg, tcfg = jenc.EncoderConfig(**SMALL), tenc.EncoderConfig(**SMALL)
    params = jenc.init_params(jax.random.PRNGKey(0), jcfg)
    return jcfg, tcfg, params


def test_tokenize_bit_for_bit(small):
    jcfg, tcfg, _ = small
    for text in TEXTS:
        assert np.array_equal(tenc.tokenize(text, tcfg), jenc.tokenize(text, jcfg)), text
    assert np.array_equal(tenc.tokenize_batch(TEXTS, tcfg), jenc.tokenize_batch(TEXTS, jcfg))
    full = jenc.EncoderConfig()
    assert np.array_equal(tenc.tokenize_batch(TEXTS, tenc.EncoderConfig()),
                          jenc.tokenize_batch(TEXTS, full))


@pytest.mark.parametrize("seed", [0, 5])
def test_split_is_bit_for_bit(seed):
    key = jax.random.PRNGKey(seed)
    assert np.array_equal(tenc.prng_key(seed), np.asarray(key))
    assert np.array_equal(tenc.split(tenc.prng_key(seed), 36),
                          np.asarray(jax.random.split(key, 36)))


def test_normal_within_a_few_ulps():
    key = np.asarray(jax.random.split(jax.random.PRNGKey(0), 8))[3]
    want = np.asarray(jax.random.normal(key, (300, 77), dtype=jnp.float32))
    got = tenc.normal(key, (300, 77))
    assert got.dtype == np.float32 and got.shape == want.shape
    assert np.abs(got - want).max() <= 5e-7
    assert (got == want).mean() > 0.95


@pytest.mark.parametrize("kw", [SMALL, {}], ids=["small", "default"])
def test_seed_init_matches_jax(kw):
    """init_params(PRNGKey(0)) of the JAX package, within 1e-4, at the small
    test config and at the full default (vocab 32768, d_model 256, 4 layers,
    out 768)."""
    want = tenc.flatten_tree(jax.tree.map(np.asarray, jenc.init_params(
        jax.random.PRNGKey(0), jenc.EncoderConfig(**kw))))
    got = tenc.init_params(0, tenc.EncoderConfig(**kw))
    assert set(got) == set(want)
    for k in want:
        assert got[k].shape == want[k].shape and got[k].dtype == torch.float32
        assert float(np.abs(got[k].numpy() - want[k]).max()) <= 1e-4, k


def test_forward_f32_and_bf16_match_jax(small):
    jcfg, tcfg, params = small
    ids = jenc.tokenize_batch(TEXTS, jcfg)
    state = tenc.params_from_numpy(jax.tree.map(np.asarray, params))
    out = {}
    for dtype in ("float32", "bfloat16"):
        want = np.asarray(jenc.forward(params, jnp.asarray(ids),
                                       dataclasses.replace(jcfg, compute_dtype=dtype)))
        got = tenc.Encoder.from_state(state, dataclasses.replace(tcfg, compute_dtype=dtype),
                                      "cpu")(
            torch.from_numpy(ids)).numpy()
        out[dtype] = (got, want)
    got32, want32 = out["float32"]
    assert np.abs(got32 - want32).max() <= 1e-5
    gap = np.abs(out["bfloat16"][1] - want32).max()  # the JAX package's own
    assert np.abs(out["bfloat16"][0] - out["bfloat16"][1]).max() <= 2 * gap
    # blank texts embed to the zero row (masked pool, norm floor)
    for i, text in enumerate(TEXTS):
        if not text.strip():
            assert not out["bfloat16"][0][i].any()
    norms = np.linalg.norm(out["bfloat16"][0], axis=1)
    assert np.allclose(norms[[i for i, t in enumerate(TEXTS) if t.strip()]], 1.0, atol=1e-5)


def test_functional_forward_equals_the_module(small):
    _, tcfg, _ = small
    state = tenc.init_params(0, tcfg)
    ids = tenc.tokenize_batch(TEXTS, tcfg)
    a = tenc.forward(state, ids, tcfg, device="cpu")
    b = tenc.Encoder.from_state(state, tcfg, "cpu")(torch.from_numpy(ids))
    assert torch.equal(a, b)


def test_the_encoder_runs_on_the_card_unless_asked_for_the_cpu(small):
    _, tcfg, _ = small
    state = tenc.init_params(0, tcfg)
    ids = tenc.tokenize_batch(TEXTS, tcfg)
    if torch.cuda.is_available():
        assert tenc.Encoder.from_state(state, tcfg).tok_embed.is_cuda
        assert tenc.forward(state, ids, tcfg).is_cuda
        return
    with pytest.raises(RuntimeError, match="CUDA device requested"):
        tenc.Encoder.from_state(state, tcfg)
    with pytest.raises(RuntimeError, match="CUDA device requested"):
        tenc.forward(state, ids, tcfg)


def test_checkpoints_cross_both_ways(small, tmp_path):
    jcfg, tcfg, params = small
    ids = jenc.tokenize_batch(TEXTS, jcfg)
    # JAX writes, the port reads
    jpath = str(tmp_path / "jax_ckpt")
    jenc.save_params(jpath, params, jcfg)
    state, cfg = tenc.load_params(jpath)
    assert cfg == tcfg
    want = tenc.flatten_tree(jax.tree.map(np.asarray, params))
    assert all(np.array_equal(state[k].numpy(), want[k]) for k in want)
    # the port writes (a module's state, different weights), JAX reads
    other = tenc.Encoder.from_state(tenc.init_params(3, tcfg), tcfg, "cpu")
    tpath = str(tmp_path / "port_ckpt")
    tenc.save_params(tpath, other, tcfg)
    jparams, jcfg2 = jenc.load_params(tpath)
    assert jcfg2 == jcfg
    flat = tenc.flatten_tree(jax.tree.map(np.asarray, jparams))
    assert set(flat) == set(other.state_dict())
    assert all(np.array_equal(flat[k], v.numpy()) for k, v in other.state_dict().items())
    f32 = dataclasses.replace(jcfg, compute_dtype="float32")
    got = tenc.Encoder.from_state(tenc.load_params(tpath)[0],
                                  dataclasses.replace(tcfg, compute_dtype="float32"), "cpu")(
        torch.from_numpy(ids)).numpy()
    assert np.abs(got - np.asarray(jenc.forward(jparams, jnp.asarray(ids), f32))).max() <= 1e-5


def test_client_embed_batch_and_device_agree_with_jax(small, tmp_path):
    """The port's client (seed init at the small config) against the JAX
    client: the same statuses, vectors within the bf16 tolerance. embed,
    embed_batch and embed_device: bit for bit on one batch (one bucket
    shape), within the bf16 tolerance across bucket shapes (a product's f32
    bits may depend on the shape, and one f32 ulp before a bf16 rounding
    becomes a bf16 ulp)."""
    jcfg, tcfg, _ = small
    jc = jemb.LocalEncoderEmbeddingClient(dim=48, cfg=jcfg)
    tc = temb.LocalEncoderEmbeddingClient(dim=48, cfg=tcfg, device="cpu")
    assert tc.dim == jc.dim == 48 and tc.model == jc.model
    jb, tb = jc.embed_batch(TEXTS), tc.embed_batch(TEXTS)
    assert [r.status for r in tb] == [r.status for r in jb]
    live = [i for i, t in enumerate(TEXTS) if t.strip()]
    for i in live:
        assert np.abs(np.array(tb[i].vector) - np.array(jb[i].vector)).max() <= 1e-2
        single = tc.embed(TEXTS[i])
        assert single.status == temb.EmbeddingStatus.SUCCESS
        assert np.abs(np.array(single.vector) - np.array(tb[i].vector)).max() <= 1e-2
    dev = tc.embed_device(TEXTS).numpy()
    assert dev.shape == (len(TEXTS), 48)
    rows = tc.embed_rows(TEXTS)
    assert np.array_equal(dev, rows)
    rows_live = tc.embed_rows([TEXTS[i] for i in live])
    assert np.array_equal(rows_live, np.array([tb[i].vector for i in live], dtype=np.float32))
    assert not dev[[i for i, t in enumerate(TEXTS) if not t.strip()]].any()
    assert tc.embed("").status == temb.EmbeddingStatus.EMPTY
    # a checkpoint path, and the dim check
    path = str(tmp_path / "c.npz")
    tenc.save_params(path, tc.params, tcfg)
    loaded = temb.LocalEncoderEmbeddingClient(dim=48, checkpoint=path, device="cpu")
    assert loaded.model == f"local-encoder:{path}"
    assert np.array_equal(loaded.embed_rows(TEXTS), rows)
    with pytest.raises(ValueError, match="out_dim"):
        temb.LocalEncoderEmbeddingClient(dim=64, checkpoint=path, device="cpu")
    # a hot swap changes the embeddings
    tc.swap_params(tenc.init_params(4, tcfg), tag="t")
    assert tc.model == "local-encoder:t"
    assert not np.array_equal(tc.embed_rows(TEXTS), rows)
