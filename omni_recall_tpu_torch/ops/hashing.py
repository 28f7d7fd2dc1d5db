"""Character-n-gram bloom signatures for device-side keyword upper bounds.

The reference's keyword component is *substring containment*: the fraction of
distinct query terms contained (ordinal, lowercased) in the chunk content
(src/OmniRecall.Api/Services/RecallSearchService.cs:90-113). Substring match
cannot be computed exactly on-device at scale, so the device kernel computes a
**sound upper bound** instead and the host exact-rescores the top candidates:

- Each chunk stores a bloom signature over the character n-grams of its
  lowercased content (gram lengths {1, 2, NGRAM}; terms contain no
  whitespace, so whitespace-crossing grams are skipped).
- A query term ``t`` that IS a substring of the content has every one of its
  grams present in the content, hence every probed bit set. Therefore
  ``kw_ub >= kw_exact`` always (bloom false positives and unprobed grams only
  push the bound UP).
- Per query we build a dense weight vector ``w`` over bloom bits with
  ``sum_{j in S_t} w[j] = 1/T`` for each term ``t`` (weight 1/(T*|S_t|) per
  bit, summed over terms sharing a bit). Then
  ``kw_ub(chunk) = sum_j w[j] * bit[chunk, j]`` — a single [bits] dot product
  per chunk that rides the MXU as ``bits @ W`` for a whole query batch.

Soundness: for every present term all bits in S_t are set, contributing the
full 1/T; absent terms contribute >= 0. Hence kw_ub >= (#present)/T = kw.
"""

from __future__ import annotations

import numpy as np

_FNV_OFFSET = 0xCBF29CE484222325
_FNV_PRIME = 0x100000001B3
_MASK64 = 0xFFFFFFFFFFFFFFFF


def fnv1a(data: bytes, seed: int = 0) -> int:
    h = (_FNV_OFFSET ^ (seed * 0x9E3779B97F4A7C15)) & _MASK64
    for b in data:
        h ^= b
        h = (h * _FNV_PRIME) & _MASK64
    return h


def _gram_positions(gram: str, bloom_bits: int, n_hashes: int) -> list[int]:
    data = gram.encode("utf-8", errors="surrogatepass")
    h1 = fnv1a(data, seed=1)
    h2 = fnv1a(data, seed=2) | 1
    # the & _MASK64 wrap matches C uint64 arithmetic (keyword_scorer.c
    # set_gram) — without it Python's unbounded h1 + i*h2 diverges from the
    # native builder for every non-power-of-two bloom_bits, silently
    # breaking the bit-identical contract (and certificate soundness)
    return [(((h1 + i * h2) & _MASK64) % bloom_bits) for i in range(n_hashes)]


def term_grams(term: str, ngram: int) -> list[str]:
    """Grams probed for a query term (lengths {1, 2, ngram} scheme).

    len==1 -> the single char; len in [2, ngram) -> all 2-grams;
    len >= ngram -> all ngram-grams (capped at 16, evenly sampled — probing a
    SUBSET of a term's grams keeps the upper bound sound, just looser).
    """
    L = len(term)
    if L == 0:
        return []
    if L == 1:
        grams = [term]
    elif L < ngram:
        grams = [term[i : i + 2] for i in range(L - 1)]
    else:
        grams = [term[i : i + ngram] for i in range(L - ngram + 1)]
    if len(grams) > 16:
        idx = np.linspace(0, len(grams) - 1, 16).astype(int)
        grams = [grams[i] for i in idx]
    return list(dict.fromkeys(grams))


def content_grams(content_lower: str, ngram: int) -> set[str]:
    """All grams of lengths {1, 2, ngram} of the content, skipping
    whitespace-containing grams (query terms never contain whitespace)."""
    grams: set[str] = set()
    L = len(content_lower)
    # dedupe lengths KEEPING one occurrence: the old `skip n==2 when
    # ngram==2` skipped BOTH length-2 entries, leaving ngram=2 signatures
    # with no 2-gram bits while term_grams probes them (unsound bound)
    for n in dict.fromkeys((1, 2, ngram)):
        for i in range(L - n + 1):
            g = content_lower[i : i + n]
            if not any(ch.isspace() for ch in g):
                grams.add(g)
    return grams


def chunk_signature(
    content_lower: str, bloom_bits: int, ngram: int, n_hashes: int
) -> np.ndarray:
    """Packed u8 bloom signature (shape [W = bloom_bits // 8]) for a chunk.

    Kernel-friendly bit layout: bit position j lives in word (j mod W) at bit
    (j div W). Decoding is then a lane-aligned concatenation of the 8
    shift-AND planes ``[(words >> b) & 1 for b in range(8)]`` — no
    minor-dimension reshapes on TPU (see ops/pallas_scorer.py).
    """
    assert bloom_bits % 8 == 0
    w = bloom_bits // 8
    words = np.zeros(w, dtype=np.uint8)
    for gram in content_grams(content_lower, ngram):
        for pos in _gram_positions(gram, bloom_bits, n_hashes):
            words[pos % w] |= np.uint8(1 << (pos // w))
    return words


def query_bit_weights(
    terms: list[str], bloom_bits: int, ngram: int, n_hashes: int
) -> tuple[np.ndarray, float]:
    """Dense f32[bloom_bits] weight vector with sum_{j in S_t} w[j] >= 1/T per
    term, plus a constant bias for terms that produce no probe positions
    (counting such a term as always-matched keeps the bound sound)."""
    weights = np.zeros(bloom_bits, dtype=np.float32)
    bias = 0.0
    if not terms:
        return weights, bias
    inv_t = 1.0 / len(terms)
    for term in terms:
        positions: set[int] = set()
        for gram in term_grams(term, ngram):
            positions.update(_gram_positions(gram, bloom_bits, n_hashes))
        if not positions:
            bias += inv_t
            continue
        w = inv_t / len(positions)
        for pos in positions:
            weights[pos] += w
    return weights, bias


def query_bit_weights_batch(
    term_lists: list[list[str]], bloom_bits: int, ngram: int, n_hashes: int
) -> tuple[np.ndarray, np.ndarray]:
    """Batched query_bit_weights: ASCII-only queries go through the native
    C builder (byte-level grams == character-level grams for ASCII, and
    identical f32 accumulation); others fall back per query. Results are
    bit-identical either way (tests/test_native.py). The per-query Python
    builder costs ~16-80 us — ~25-125 ms per 1536-query serving batch —
    so the dispatch path calls this instead."""
    nq = len(term_lists)
    weights = np.zeros((nq, bloom_bits), dtype=np.float32)
    bias = np.zeros(nq, dtype=np.float64)
    ascii_idx = [
        i for i, terms in enumerate(term_lists)
        if all(t.isascii() for t in terms)
    ]
    ascii_set = set(ascii_idx)
    python_idx = [i for i in range(nq) if i not in ascii_set]
    if ascii_idx:
        from omni_recall_tpu_torch.ops import native

        out = native.query_bit_weights_batch(
            [[t.encode("ascii") for t in term_lists[i]] for i in ascii_idx],
            bloom_bits, ngram, n_hashes,
        )
        if out is not None:
            weights[ascii_idx] = out[0]
            bias[ascii_idx] = out[1]
        else:
            python_idx = list(range(nq))
    for i in python_idx:
        weights[i], bias[i] = query_bit_weights(
            term_lists[i], bloom_bits, ngram, n_hashes
        )
    return weights, bias


def query_bit_weights_sparse_batch(
    term_lists: list[list[str]], bloom_bits: int, ngram: int, n_hashes: int
) -> tuple[np.ndarray, np.ndarray, np.ndarray] | None:
    """SPARSE batched query bit-weights: (idx i32[nq, t_pad] with -1
    padding, val f32[nq, t_pad], bias f64[nq]) such that scattering each
    query's (idx, val) pairs into a zero [bloom_bits] row reproduces
    query_bit_weights_batch's dense row BIT-FOR-BIT (the native builder
    accumulates f32 in the identical order; tests/test_native.py).

    This is the serving dispatch path: the dense [nq, bloom_bits] matrix
    (6.3 MB at 1536x1024) is never materialized on the host — the engine
    scatters on device (_densify_kw). Returns None when the native lib is
    unavailable or a query is pathologically dense (t_pad would exceed
    bloom_bits // 4, where the dense upload wins); the caller then uses the
    dense builder."""
    from omni_recall_tpu_torch.ops import native

    nq = len(term_lists)
    ascii_idx = [
        i for i, terms in enumerate(term_lists)
        if all(t.isascii() for t in terms)
    ]
    enc = [[t.encode("ascii") for t in term_lists[i]] for i in ascii_idx]

    # non-ASCII queries (rare): dense python row -> nonzero extraction
    py_rows: list[tuple[int, np.ndarray, np.ndarray, float]] = []
    py_max = 0
    if len(ascii_idx) < nq:
        ascii_set = set(ascii_idx)
        for i in range(nq):
            if i in ascii_set:
                continue
            w_row, b_i = query_bit_weights(
                term_lists[i], bloom_bits, ngram, n_hashes
            )
            nz = np.nonzero(w_row)[0]
            py_rows.append((i, nz, w_row[nz], b_i))
            py_max = max(py_max, len(nz))

    t_pad = 16
    out = native.query_bit_weights_sparse_batch(
        enc, bloom_bits, ngram, n_hashes, t_pad
    )
    if out is None:
        return None
    idx_a, val_a, bias_a, counts = out
    max_c = max(int(counts.max()) if len(counts) else 0, py_max)
    if max_c > t_pad:
        t_pad = 1 << (max_c - 1).bit_length()
        if t_pad > bloom_bits // 4:
            return None  # dense enough that the dense path wins
        out = native.query_bit_weights_sparse_batch(
            enc, bloom_bits, ngram, n_hashes, t_pad
        )
        if out is None:
            return None
        idx_a, val_a, bias_a, counts = out

    idx = np.full((nq, t_pad), -1, dtype=np.int32)
    val = np.zeros((nq, t_pad), dtype=np.float32)
    bias = np.zeros(nq, dtype=np.float64)
    if ascii_idx:
        idx[ascii_idx] = idx_a
        val[ascii_idx] = val_a
        bias[ascii_idx] = bias_a
    for i, nz, vals, b_i in py_rows:
        idx[i, : len(nz)] = nz
        val[i, : len(nz)] = vals
        bias[i] = b_i
    return idx, val, bias


def chunk_signatures_batch(
    contents_lower: list[str], bloom_bits: int, ngram: int, n_hashes: int
) -> np.ndarray:
    """Batched signature construction: ASCII contents go through the native
    C builder (byte-level == character-level grams for ASCII); anything else
    falls back to the Python builder. Results are identical either way."""
    n = len(contents_lower)
    out = np.zeros((n, bloom_bits // 8), dtype=np.uint8)
    if n == 0:
        return out
    is_ascii = [c.isascii() for c in contents_lower]
    ascii_idx = [i for i, ok in enumerate(is_ascii) if ok]
    python_idx = [i for i, ok in enumerate(is_ascii) if not ok]
    if ascii_idx:
        from omni_recall_tpu_torch.ops import native

        sigs = native.chunk_signatures(
            [contents_lower[i].encode("ascii") for i in ascii_idx],
            bloom_bits, ngram, n_hashes,
        )
        if sigs is not None:
            out[ascii_idx] = sigs
        else:
            python_idx = list(range(n))
    for i in python_idx:
        out[i] = chunk_signature(contents_lower[i], bloom_bits, ngram, n_hashes)
    return out


def unpack_bits(words: np.ndarray, bloom_bits: int) -> np.ndarray:
    """u8[..., W] -> f32[..., bloom_bits] bit expansion; bit j = plane
    (j div W) of word (j mod W), i.e. concat of 8 shift-AND planes."""
    planes = [((words >> b) & 1) for b in range(8)]
    return np.concatenate(planes, axis=-1).astype(np.float32)
