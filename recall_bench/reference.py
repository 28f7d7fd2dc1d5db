"""The plain reference of the served search: the upstream hybrid score and
its ranking, in NumPy, over the benchmark's own corpus.

score = (0.7 * cos + 0.2 * kw) + 0.1 * recency, the reference's
``RecallSearchService.cs:66``, which the port serves certified exact:

- cos: f32 elementwise products accumulated in f64, over f64 norms
  accumulated the same way (``ops/oracle.py cosine_similarity``);
- kw: the share of the query's distinct lowercased whitespace terms that
  are substrings of the lowercased content (the benchmark's terms are
  cluster tokens, none of them a stop word, so the stop-word rule is moot);
- recency: exp(-age_days / 30), the age from exact integer microseconds;
- ties: the newer row first (created timestamp, then row sequence).

It imports nothing of the program and takes nothing the program made.

``top_k`` scans every row: a first pass with exact f64 products keeps each
row whose score lies within ``MARGIN`` of the running k-th best (the two
product semantics differ by at most 0.7 * 2^-23 for unit rows, far below
``MARGIN``), and the survivors are scored exactly. ``control_top_k`` is the
same ranking computed in float32 throughout, the precision below the
configuration's f64 (the control of the comparison).
"""

from __future__ import annotations

import numpy as np

COSINE_WEIGHT, KEYWORD_WEIGHT, RECENCY_WEIGHT = 0.7, 0.2, 0.1
HALF_LIFE_DAYS = 30.0
US_PER_MILLIDAY = 86_400_000
EPOCH_US = 1_704_067_200_000_000   # 2024-01-01T00:00:00Z, the corpus's day 0
MARGIN = 1e-6
BLOCK = 1 << 16


class Reference:
    def __init__(self, corpus):
        self.c = corpus
        self.now_md = int(round(corpus.days * 1000))
        age = ((self.now_md - corpus.millidays) * US_PER_MILLIDAY).astype(np.float64) / 1e6 / 86400.0
        self.age = np.maximum(0.0, age)
        self.rec = np.exp(-self.age / HALF_LIFE_DAYS)
        self.created_ts = (EPOCH_US + corpus.millidays * US_PER_MILLIDAY).astype(np.float64) / 1e6
        self.lower = [s.lower() for s in corpus.contents]

    # -- parts --

    @staticmethod
    def terms(text: str) -> list:
        return list(dict.fromkeys(t.lower() for t in text.split()))

    def kw_by_cluster(self, text: str) -> np.ndarray:
        terms = self.terms(text)
        hits = np.zeros(len(self.lower), dtype=np.float64)
        for t in terms:
            hits += np.char.find(np.asarray(self.lower), t) >= 0
        return hits / len(terms) if terms else hits

    def _kw_pairs(self, texts: list, qidx: np.ndarray, rows: np.ndarray) -> np.ndarray:
        terms = [self.terms(t) for t in texts]
        clusters = self.c.assign[rows]
        memo: dict = {}
        kw = np.empty(len(rows), dtype=np.float64)
        for i, (q, c) in enumerate(zip(qidx.tolist(), clusters.tolist())):
            v = memo.get((q, c))
            if v is None:
                ts = terms[q]
                v = memo[(q, c)] = (sum(t in self.lower[c] for t in ts) / len(ts)) if ts else 0.0
            kw[i] = v
        return kw

    def _queries(self, requests: list):
        """(f32 [m, d] query rows, zero where a request has none; f64 squared norms)."""
        d = self.c.emb.shape[1]
        qs = np.zeros((len(requests), d), dtype=np.float32)
        for j, r in enumerate(requests):
            if r[1] is not None:
                qs[j] = np.asarray(r[1], dtype=np.float32)
        return qs, np.sum((qs * qs).astype(np.float64), axis=1)

    def pair_scores(self, requests: list, qidx: np.ndarray, rows: np.ndarray) -> np.ndarray:
        """Exact scores of the pairs (request qidx[i], row rows[i])."""
        qidx = np.asarray(qidx, dtype=np.int64)
        rows = np.asarray(rows, dtype=np.int64)
        qs, qn_all = self._queries(requests)
        kw = self._kw_pairs([r[0] for r in requests], qidx, rows)
        cos = np.zeros(len(rows), dtype=np.float64)
        for lo in range(0, len(rows), BLOCK):
            sl = slice(lo, lo + BLOCK)
            e = self.c.emb[rows[sl]]
            dot = np.sum(e * qs[qidx[sl]], axis=1, dtype=np.float64)
            ns = np.sum(e * e, axis=1, dtype=np.float64)
            qn = qn_all[qidx[sl]]
            ok = (ns > 0.0) & (qn > 0.0)
            part = np.zeros(len(dot), dtype=np.float64)
            part[ok] = dot[ok] / (np.sqrt(qn[ok]) * np.sqrt(ns[ok]))
            cos[sl] = part
        return (COSINE_WEIGHT * cos + KEYWORD_WEIGHT * kw) + RECENCY_WEIGHT * self.rec[rows]

    def rank(self, rows: np.ndarray, scores: np.ndarray, k: int):
        order = np.lexsort((-rows, -self.created_ts[rows], -scores))[:k]
        return rows[order], scores[order]

    # -- whole scans --

    def top_k(self, requests: list, k: int) -> list:
        """[(rows, exact scores)] of each (text, emb) request, best first."""
        m = len(requests)
        if m == 0:
            return []
        n = self.c.n
        kws = np.stack([self.kw_by_cluster(t) for t, *_ in requests], axis=1)   # [C, m]
        qs = self._queries(requests)[0].astype(np.float64)
        qnorm = np.sqrt(np.sum(qs * qs, axis=1))
        qnorm[qnorm == 0] = np.inf
        kth = np.full(m, -np.inf)
        tops = [np.empty(0) for _ in range(m)]
        cand = [[] for _ in range(m)]
        for lo in range(0, n, BLOCK):
            hi = min(n, lo + BLOCK)
            e = self.c.emb[lo:hi].astype(np.float64)
            enorm = np.sqrt(np.einsum("ij,ij->i", e, e))
            enorm[enorm == 0] = np.inf
            approx = COSINE_WEIGHT * ((e @ qs.T) / enorm[:, None] / qnorm[None, :])
            approx += KEYWORD_WEIGHT * kws[self.c.assign[lo:hi]]
            approx += RECENCY_WEIGHT * self.rec[lo:hi, None]
            for j in range(m):
                col = approx[:, j]
                top = np.concatenate([tops[j], np.partition(col, -min(k, len(col)))[-k:]])
                tops[j] = np.partition(top, -k)[-k:] if len(top) > k else top
                if len(tops[j]) >= k:
                    kth[j] = tops[j].min()
                cand[j].append(lo + np.nonzero(col >= kth[j] - MARGIN)[0])
        out = []
        for j in range(m):
            rows = np.concatenate(cand[j])
            exact = self.pair_scores(requests[j:j + 1], np.zeros(len(rows), np.int64), rows)
            out.append(self.rank(rows, exact, k))
        return out

    def control_top_k(self, requests: list, k: int) -> list:
        """The same ranking computed in float32 (products, sums, norms and
        the score): [(rows, f32 scores as f64)]."""
        f32 = np.float32
        n = self.c.n
        rec32 = np.exp(-self.age.astype(f32) / f32(HALF_LIFE_DAYS))
        out = []
        for text, emb, *_ in requests:
            kw32 = self.kw_by_cluster(text).astype(f32)
            q = np.zeros(self.c.emb.shape[1], f32) if emb is None else np.asarray(emb, f32)
            qn = np.sqrt(np.dot(q, q))
            scores = np.empty(n, dtype=f32)
            for lo in range(0, n, BLOCK):
                hi = min(n, lo + BLOCK)
                e = self.c.emb[lo:hi]
                en = np.sqrt(np.einsum("ij,ij->i", e, e))
                cos = (e @ q) / (en * qn) if qn > 0 else np.zeros(hi - lo, f32)
                scores[lo:hi] = (f32(COSINE_WEIGHT) * cos + f32(KEYWORD_WEIGHT)
                                 * kw32[self.c.assign[lo:hi]]) + f32(RECENCY_WEIGHT) * rec32[lo:hi]
            top = np.argpartition(scores, -4 * k)[-4 * k:]
            rows, s = self.rank(top.astype(np.int64), scores[top].astype(np.float64), k)
            out.append((rows, s))
        return out
