"""T4: K1's scan with three emit layouts of its packed-key extraction.

Counterpart of the repository's ``tools/probe_keys_emit.py`` (``kern_pair``
:123, ``kern_p3`` :136 and ``kern_pf`` :142, built by ``make_kernels``). Over
``emb8`` i8 [N, d], ``q8`` i8 [B, d], ``scale`` f32 [1, N] and ``qs`` f32
[B, 1], the tool's bare scores

    score = (cosd * qs) * scale

(no add_row, bias or eps; the order found against the tool's interpret-mode
body at sub = 1, where each key is a whole score: over 1024 rows and 16
queries with random ``qs`` and ``scale`` this form agrees on all 16384
scores, ``cosd * (qs * scale)`` misses 5715 and ``(cosd * scale) * qs``
5706, tests/test_torch_probe_keys_emit.py), then per slice of ``sub`` rows
(a power of two) the packed-key rounds of ``_extract_topt`` at any t1:
t1 - 1 rounds of the largest key, each masking every entry equal to it,
then the largest left (the bound). Three emits, with nb = N/c and n_sub = c/sub:

- ``pair``: the decoded values f32 and global row indices i32 (-2 for the
  bound), [nb, B, n_sub·t1], block-major;
- ``p3``: the raw packed keys i32 in the same layout;
- ``pf``: the raw packed keys i32 flat, [B, nb·n_sub·t1].

The kernel is K1's first design (``csrc/int8_scan.cu``: ``int8_scan_kernel``
with ``KeysArgs``, int8 ``wgmma`` over rows streamed by TMA, the register
extraction of its shared-memory scores; K1 itself now runs in
``csrc/int8_coarse.cu``) with the bare epilogue and the emit as its argument; it writes
each layout itself, since the layout is what the probe measures. It takes
K1's shapes: N % 128 == 0 and d % 16 == 0 beside the tool's rules. A CUDA
tensor launches the kernel or raises; a CPU tensor takes the plain version.

``python -m omni_recall_tpu_torch.tools.probe_keys_emit`` runs the tool's
configuration (N = 2^20, d = 768, B = 1536, c = sub = 1024, t1 = 3) on the
card (``--device cpu`` for the plain version): first its checks at N/8 (P3
decoded equals pair's values bit for bit, PF equals P3 transposed), then the
three emits timed, each on the tool's line; then one JSON line.
"""

from __future__ import annotations

import argparse
import json

import torch

from omni_recall_tpu_torch.device import resolve_device
from omni_recall_tpu_torch.ops import cuda
from omni_recall_tpu_torch.ops.scorer import (
    INT8_TILE_ROWS,
    _check_cuda_operands,
    _decode_keys,
    _int_dot,
    _packed_keys_plain,
    _ptr,
    _require_cpu,
    decode_up,
)
from omni_recall_tpu_torch.tools import bits_equal, device_name, median_ms

EMITS = {"pair": 0, "p3": 1, "pf": 2}  # -> csrc/int8_scan.cu KeysEmit
LABELS = {"pair": "pair (vals+idxs, 3D)", "p3": "P3  (packed keys, 3D)",
          "pf": "PF  (packed keys, flat)"}
N, D, B = 1 << 20, 768, 1536  # the tool's configuration
C = SUB = 1024
T1 = 3
QUERY_CHUNK = 64  # queries the plain version scores at a time


def _check(n: int, c: int, sub: int, t1: int, emit: str) -> None:
    if emit not in EMITS:
        raise ValueError(f"unknown T4 emit {emit!r}; one of {sorted(EMITS)}")
    if sub < 1 or sub & (sub - 1) or c % sub or n % c or not 1 <= t1 <= sub:
        raise ValueError(f"T4 needs sub a power of two, c % sub == 0, N % c == 0 and "
                         f"1 <= t1 <= sub, got N={n}, c={c}, sub={sub}, t1={t1}")


def keys_scan(emb8, q8, scale, qs, c: int, sub: int, t1: int, emit: str):
    """T4: (vals, idxs) for ``pair``, the keys for ``p3`` and ``pf``."""
    n, b = emb8.shape[0], q8.shape[0]
    _check(n, c, sub, t1, emit)
    if not emb8.is_cuda:
        _require_cpu(emb8)
        return keys_scan_plain(emb8, q8, scale, qs, c, sub, t1, emit)
    d = emb8.shape[1]
    if d % 16 or n % max(sub, INT8_TILE_ROWS):
        raise ValueError(f"the CUDA T4 kernel needs d % 16 == 0 and "
                         f"N % max(sub, {INT8_TILE_ROWS}) == 0, got N={n}, d={d}, sub={sub}")
    f32 = torch.float32
    scale, qs = scale.reshape(-1), qs.reshape(-1)
    _check_cuda_operands(
        emb8.device, emb8=(emb8, torch.int8, (n, d)), q8=(q8, torch.int8, (b, d)),
        scale=(scale, f32, (n,)), qs=(qs, f32, (b,)),
    )
    width = (c // sub) * t1
    shape = (b, (n // c) * width) if emit == "pf" else (n // c, b, width)
    keys = torch.empty(shape, dtype=torch.int32, device=emb8.device)  # or pair's idxs
    vals = torch.empty(shape, dtype=f32, device=emb8.device) if emit == "pair" else None
    lib = cuda.library("int8_scan")
    rc = lib.omni_int8_keys_emit(
        _ptr(emb8), _ptr(q8), _ptr(scale), _ptr(qs), _ptr(vals), _ptr(keys),
        n, d, b, c, sub, t1, EMITS[emit], cuda.stream_ptr(emb8.device),
    )
    cuda.check(lib, rc, f"probe_keys_emit[{emit}]")
    cuda.count_launch("probe_keys_emit")
    return (vals, keys) if emit == "pair" else keys


def keys_scan_plain(emb8, q8, scale, qs, c: int, sub: int, t1: int, emit: str):
    """Plain PyTorch T4: the scores in the tool's order, K1's plain
    packed-key rounds (``_packed_keys_plain``), the emit's layout."""
    n, b = emb8.shape[0], q8.shape[0]
    _check(n, c, sub, t1, emit)
    scale, qs = scale.reshape(1, -1), qs.reshape(-1, 1)
    keys = torch.cat([
        _packed_keys_plain((_int_dot(q8[i:i + QUERY_CHUNK], emb8) * qs[i:i + QUERY_CHUNK])
                           * scale, sub, t1)
        for i in range(0, b, QUERY_CHUNK)])  # [B, N/sub, t1]
    if emit == "pf":
        return keys.reshape(b, -1)

    def block_major(x):
        return x.reshape(b, n // c, (c // sub) * t1).transpose(0, 1).contiguous()

    if emit == "p3":
        return block_major(keys)
    vals, idxs = _decode_keys(keys, sub)
    return block_major(vals), block_major(idxs)


def tool_inputs(n: int, b: int, device: torch.device, seed: int = 0):
    """The tool's operands: rows and queries of random bits read as int8
    (so -128 occurs), scale and qs 1e-4."""
    g = torch.Generator(device=device).manual_seed(seed)

    def bits(shape):
        return torch.randint(0, 256, shape, generator=g, device=device).to(torch.uint8).view(
            torch.int8)

    return (bits((n, D)), bits((b, D)), torch.full((1, n), 1e-4, device=device),
            torch.full((b, 1), 1e-4, device=device))


def main(n: int = N, device: str = "cuda", runs: int = 8) -> list[dict]:
    """The tool's checks at N/8 (at least one block), then each emit timed
    as the median of ``runs`` calls after a warm-up. Prints the tool's lines,
    then one JSON line; returns one record per emit (its launches include
    its check launch). Raises if a check fails."""
    dev = resolve_device(device)
    emb, q, scale, qs = tool_inputs(n, B, dev)
    launches = {}

    def run(emit, n_rows):
        before = cuda.LAUNCHES["probe_keys_emit"]
        out = keys_scan(emb[:n_rows], q, scale[:, :n_rows], qs, C, SUB, T1, emit)
        launches[emit] = launches.get(emit, 0) + cuda.LAUNCHES["probe_keys_emit"] - before
        return out

    n_c = max(n // 8, C)
    v0, _ = run("pair", n_c)
    k3 = run("p3", n_c)
    if not bits_equal(decode_up(k3, SUB), v0):
        raise AssertionError("P3 decode != pair vals")
    print("P3 decode: bit-identical to the pair emit", flush=True)
    kf = run("pf", n_c)
    if not bits_equal(kf.reshape(B, n_c // C, -1), k3.transpose(0, 1)):
        raise AssertionError("PF flat layout values diverge from P3")
    print("PF flat layout: matches P3", flush=True)
    del v0, k3, kf
    records = []
    for emit in EMITS:
        ms = median_ms(lambda: run(emit, n), dev, runs)  # noqa: B023
        print(f"{LABELS[emit]:34s} {ms:8.3f} ms/batch", flush=True)
        records.append({"emit": emit, "c": C, "sub": SUB, "t1": T1, "ms": ms,
                        "launches": launches[emit]})
    print(json.dumps({"tool": "probe_keys_emit", "device": device_name(dev), "n": n, "d": D,
                      "b": B, "runs": runs, "records": records}), flush=True)
    return records


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    main(device=parser.parse_args().device)
