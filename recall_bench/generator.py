"""The one traffic generator: a traffic mix's parameters (a JSON file under
``recall_bench/traffic/``) and the seed give the pool of requests the
clients send.

A request is (text, embedding f32 [d] or None, top_k). Recipes:

- ``embedding = "near_center"``: a unit vector at a cluster center plus
  ``noise`` times a random unit direction, renormalized (the cluster drawn
  uniformly); ``"none"``: no embedding (keyword-only traffic).
- ``text = "cluster_token"``: the cluster's token, for a ``kw_frac`` share
  of the requests (a uniform draw a request only when kw_frac < 1); else an
  empty text.

At ``kw_frac`` 1 the draws are those of the port's
``tools/e2e_engine.py make_requests`` for the same numpy seed, one request
after another: the cluster, then the normal direction.
"""

from __future__ import annotations

import numpy as np

from recall_bench import corpus as corpus_mod

TRAFFIC_KEYS = {"loop", "clients", "max_batch", "window_ms", "pipeline_depth", "top_k",
                "requests", "embedding", "noise", "text", "kw_frac", "ramp_s", "sample"}


def check_traffic(t: dict) -> None:
    missing = TRAFFIC_KEYS - set(t)
    if missing:
        raise ValueError(f"traffic mix lacks {sorted(missing)}")
    if t["loop"] != "closed":
        raise ValueError(f"unknown loop {t['loop']!r} (this generator drives a closed loop)")
    if t["embedding"] not in ("near_center", "none") or t["text"] not in ("cluster_token", "none"):
        raise ValueError("unknown embedding or text recipe")


def request_seed(seed: int):
    """The requests' stream, apart from the corpus tables' stream."""
    return [int(seed), 1]


def make_requests(traffic: dict, corpus, seed: int) -> list:
    """The pool of ``traffic["requests"]`` requests for ``seed``."""
    r = np.random.default_rng(request_seed(seed))
    c, d = corpus.centers.shape
    out = []
    for _ in range(traffic["requests"]):
        cluster = int(r.integers(c))
        q = None
        if traffic["embedding"] == "near_center":
            qn = r.standard_normal(d).astype(np.float32)
            qn /= np.linalg.norm(qn)
            q = corpus.centers[cluster] + traffic["noise"] * qn
            q /= np.linalg.norm(q)
        text = ""
        if traffic["text"] == "cluster_token":
            if traffic["kw_frac"] >= 1.0 or r.random() < traffic["kw_frac"]:
                text = corpus_mod.cluster_token(cluster)
        out.append((text, q, traffic["top_k"]))
    return out
