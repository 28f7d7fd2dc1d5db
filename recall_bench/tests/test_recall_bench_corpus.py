"""The benchmark's frozen corpus and request recipe against the port's
``tools/e2e_engine.py`` (the recipe it was copied from), bit for bit."""

import numpy as np

from recall_bench import corpus, generator


def spec(n, d=768):
    return {"rows": n, "dim": d, "rows_per_cluster": 64, "min_clusters": 4096,
            "noise_rows": 4096, "amp_center": 90, "amp_noise": 22, "spread": True,
            "days": 365.0}


def test_corpus_is_the_ports_bench_corpus():
    from omni_recall_tpu_torch.tools import e2e_engine

    n, d = 1 << 13, 768
    engine, make_requests, now, _ = e2e_engine.build_e2e_engine(n, d, 1024, device="cpu")
    c = corpus.make_corpus(spec(n, d), 0)       # the port's bench draws its tables at seed 0
    mine = engine.bench_corpus
    assert np.array_equal(c.emb, mine["emb"])
    assert np.array_equal(c.assign, mine["assign"])
    assert c.contents == mine["contents"]
    dix = engine.device_index
    assert np.array_equal(c.created_days, dix.created[:n])
    us = 1_704_067_200_000_000 + c.millidays * 86_400_000
    assert np.array_equal(us, dix.created_us[:n])
    assert corpus.slab_rows_for(n) == e2e_engine.slab_rows_for(n)
    # the requests: the same draws, one request after another
    traffic = {"requests": 40, "embedding": "near_center", "noise": 0.2,
               "text": "cluster_token", "kw_frac": 1.0, "top_k": 10}
    for seed in (0, 7, 2**31 + 5):
        want = make_requests(generator.request_seed(seed), 40)
        got = generator.make_requests(traffic, c, seed)
        assert [(t, k) for t, _, k in got] == [(t, k) for t, _, k in want]
        assert all(np.array_equal(a[1], b[1]) for a, b in zip(got, want))


def test_rows_match_the_ports_integer_recipe_at_other_seeds():
    from omni_recall_tpu_torch.index import compact

    for seed in (1, 12345678901):
        c = corpus.make_corpus(spec(4096, 64), seed)
        c8, n8 = compact.make_tables(corpus.n_clusters(spec(4096, 64)), 64, seed=seed,
                                     spread=True)
        assert np.array_equal(c.center8, c8) and np.array_equal(c.noise8, n8)
        q8 = compact.rows_np(0, 4096, c8, n8).astype(np.float32)
        assert np.array_equal(c.emb, q8 * c.scale[:, None])


def test_every_seed_serves_the_same_sizes():
    a = corpus.make_corpus(spec(4096, 64), 3)
    b = corpus.make_corpus(spec(4096, 64), 4)
    assert a.emb.shape == b.emb.shape and not np.array_equal(a.emb, b.emb)
    assert np.array_equal(a.millidays, b.millidays)
    norms = np.linalg.norm(a.emb.astype(np.float64), axis=1)
    assert np.all(np.abs(norms - 1) < 1e-6)
