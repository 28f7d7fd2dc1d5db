"""T5: K4's int8 body over row-major and transposed bloom.

Counterpart of the repository's ``tools/profile_bloomT.py`` (the
``pl.pallas_call`` of ``variant`` at :39, body ``kernel`` :22), an A/B of the
bloom layout under K4's scorer. Over ``emb8`` i8 [N, d], ``q8`` i8 [B, d],
``kw8`` i8 [B, 8W] (0/1 values), ``add`` f32 [1, N] and the bloom as rows
u8 [N, W] or transposed u8 [W, N] (bit j of the JAX bit matrix is bit j / W
of word j % W in both, so ``bloom.T.contiguous()`` gives the same function):

    score = fma(cosd, f32(0.7 * 1e-4), kwd * f32(0.2 * f32(1/127))) + add

with ``cosd``, ``kwd`` the exact int dots, converted to f32 (the tool's
``0.7*cos*1e-4 + 0.2*kw*(1/127.) + add`` with its constants folded and the
cosine term contracted, as XLA compiles it: found against the
interpret-mode body). Out: f32 [N/c, B, c/512], the maximum of each 512-row
slice; the values do not depend on c, only their layout does.

The kernel is K4's own (``csrc/int8_scan.cu``: int8 ``wgmma``, rows by TMA,
the keyword bit planes built in registers against ``kw8`` permuted by
``ops/scorer.py int8_kw_columns``) with the tool's epilogue, keeping the
maximum of each slice, values only. Each consumer warpgroup stages its rows
of the transposed bloom into shared memory (a 4 x 4 byte transpose of
32-bit loads along the rows) and reads them as the row layout is read. It
writes [B, N/512]; the wrapper returns that as a view in the tool's layout.
A CUDA tensor launches the kernel or raises; a CPU tensor takes the plain
version.

``python -m omni_recall_tpu_torch.tools.profile_bloomT`` runs the tool's
sweep ((B, bits, transposed) in (512, 512, T), (512, 512, F), (512, 1024, T),
(512, 1024, F), (128, 1024, T) over N = 2^20, d = 768, c = 2048) on the card
(``--device cpu`` for the plain version) and prints the tool's line for
each, then one JSON line.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from omni_recall_tpu_torch.device import resolve_device
from omni_recall_tpu_torch.ops import cuda
from omni_recall_tpu_torch.ops.scorer import (
    _bloom_bits,
    _check_cuda_operands,
    _fma32,
    _int_dot,
    _ptr,
    _require_cpu,
    int8_kw_operand,
)
from omni_recall_tpu_torch.tools import device_name, median_ms

SLICE = 512  # rows whose maximum the probe keeps
C = 2048     # the tool's block
N, D = 1 << 20, 768
CONFIGS = ((512, 512, True), (512, 512, False), (512, 1024, True), (512, 1024, False),
           (128, 1024, True))  # the tool's sweep: (B, bits, transposed)
# the tool's constants as XLA folds them, each one f32
COS_SCALE = float(np.float32(0.7) * np.float32(1e-4))
KW_SCALE = float(np.float32(0.2) * np.float32(1 / 127.0))
QUERY_CHUNK = 128  # queries the plain version scores at a time


def _shape(emb8, bloom, transposed: bool, c: int):
    n = emb8.shape[0]
    w = bloom.shape[0] if transposed else bloom.shape[1]
    if c <= 0 or c % SLICE or n % c:
        raise ValueError(f"T5 needs c % {SLICE} == 0 and N % c == 0, got N={n}, c={c}")
    return n, w


def bloom_scan(emb8, bloom, q8, kw8, add, transposed: bool, c: int = C):
    """T5 over bloom rows [N, W] or, ``transposed``, [W, N]."""
    n, w = _shape(emb8, bloom, transposed, c)
    if not emb8.is_cuda:
        _require_cpu(emb8)
        return bloom_scan_plain(emb8, bloom, q8, kw8, add, transposed, c)
    d, b = emb8.shape[1], q8.shape[0]
    if d % 16 or w % 16:
        raise ValueError(f"the CUDA T5 probe needs d % 16 == 0 and W % 16 == 0, "
                         f"got d={d}, W={w}")
    add = add.reshape(-1)
    i8 = torch.int8
    _check_cuda_operands(
        emb8.device, emb8=(emb8, i8, (n, d)),
        bloom=(bloom, torch.uint8, (w, n) if transposed else (n, w)),
        q8=(q8, i8, (b, d)), kw8=(kw8, i8, (b, 8 * w)), add=(add, torch.float32, (n,)),
    )
    out = torch.empty((b, n // SLICE), dtype=torch.float32, device=emb8.device)
    kw8 = int8_kw_operand(kw8, w)
    lib = cuda.library("int8_scan")
    rc = lib.omni_int8_probe(
        _ptr(emb8), _ptr(bloom), _ptr(q8), _ptr(kw8), _ptr(add), _ptr(out),
        n, d, w, b, int(transposed), cuda.stream_ptr(emb8.device),
    )
    cuda.check(lib, rc, "profile_bloomT")
    cuda.count_launch("profile_bloomT")
    return out.view(b, n // c, c // SLICE).transpose(0, 1)


def bloom_scan_plain(emb8, bloom, q8, kw8, add, transposed: bool, c: int = C):
    """Plain PyTorch T5."""
    n, _ = _shape(emb8, bloom, transposed, c)
    bits = _bloom_bits(bloom.T if transposed else bloom)  # [N, 8W] either way
    add = add.reshape(1, -1)
    outs = []
    for i in range(0, q8.shape[0], QUERY_CHUNK):
        sl = slice(i, i + QUERY_CHUNK)
        s = _fma32(_int_dot(q8[sl], emb8), COS_SCALE,
                   _int_dot(kw8[sl], bits) * KW_SCALE) + add
        outs.append(s.reshape(s.shape[0], n // SLICE, SLICE).amax(dim=-1))
    out = torch.cat(outs)
    return out.view(out.shape[0], n // c, c // SLICE).transpose(0, 1)


def tool_inputs(n: int, b: int, bits: int, transposed: bool, device: torch.device,
                seed: int = 0):
    """The tool's operands for one configuration: int8 rows and queries in
    [-127, 127), 0/1 keyword weights, random bloom bytes in the chosen
    layout, zero recency terms."""
    g = torch.Generator(device=device).manual_seed(seed)
    w = bits // 8

    def ri(lo, hi, shape, dtype):
        return torch.randint(lo, hi, shape, generator=g, device=device).to(dtype)

    emb8 = ri(-127, 127, (n, D), torch.int8)
    q8 = ri(-127, 127, (b, D), torch.int8)
    kw8 = ri(0, 2, (b, bits), torch.int8)
    bloom = ri(0, 256, (w, n) if transposed else (n, w), torch.uint8)
    return emb8, bloom, q8, kw8, torch.zeros((1, n), device=device)


def main(n: int = N, device: str = "cuda", runs: int = 8) -> list[dict]:
    """The tool's sweep, each configuration timed as the median of ``runs``
    calls after a warm-up. Prints the tool's line for each, then one JSON
    line; returns the records."""
    dev = resolve_device(device)
    records = []
    for b, bits, transposed in CONFIGS:
        operands = tool_inputs(n, b, bits, transposed, dev)
        before = cuda.LAUNCHES["profile_bloomT"]
        ms = median_ms(lambda: bloom_scan(*operands, transposed, C), dev, runs)  # noqa: B023
        qps = b / (ms / 1e3)
        print(f"B={b} bits={bits} T={transposed} c={C}: {ms:.2f} ms -> {qps:.0f} qps",
              flush=True)
        records.append({"b": b, "bits": bits, "transposed": transposed, "c": C, "ms": ms,
                        "qps": qps, "launches": cuda.LAUNCHES["profile_bloomT"] - before})
        del operands
    print(json.dumps({"tool": "profile_bloomT", "device": device_name(dev), "n": n, "d": D,
                      "runs": runs, "records": records}), flush=True)
    return records


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    main(device=parser.parse_args().device)
