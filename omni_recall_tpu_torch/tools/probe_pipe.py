"""T2: K1's coarse scan, software-pipelined.

Counterpart of the repository's ``tools/probe_pipe.py`` (the
``pl.pallas_call`` at :85, body ``_make_pipe_kernel`` :34). Over ``emb8`` i8
[N, d], ``q8`` i8 [B, d], ``add_row`` and ``scale_row`` f32 [1, N],
``q_scale`` f32 [B, 1] with the 0.7 cosine weight already folded in (as the
tool passes it) and ``q_bias`` f32 [B, 1]: K1's scores

    score = fma(cosd * q_scale, scale_row, add_row) + q_bias + 4e-3

and K1's per-slice top-t + bound extraction (``_extract_topt``: packed keys
when ``sub`` is a power of two and t + 1 >= 3, else the value/index
two-reduce), returned in the tool's layout: (vals f32, idxs i32)
[N/c, B, (c/sub)·(t+1)], block-major. The values depend on (sub, t) only;
``c`` sets the layout.

The tool defers the extraction of each block by one grid step, so that the
scoring of the next block can overlap it. The kernel (``csrc/int8_scan.cu``
``int8_pipe_kernel``: the tiles of K1's first design, int8 ``wgmma`` over
rows streamed by TMA) makes that overlap real inside one block of five
warpgroups: its producer and two consumer warpgroups score a group of
max(sub, 128) rows into one of two shared-memory score slots while two
extraction warpgroups run the
rounds of the group before it from the other; named barriers hand the slots
over. A block walks ``groups`` groups of one query tile (by default K1's
choice); the fill and the drain cost one group each. It writes K1's
[B, N/sub, t+1] contract, and wrapper and plain version return the view in
the tool's layout. It takes K1's shapes (d % 16 == 0, sub % 128 == 0 or
128 % sub == 0, N % max(sub, 128) == 0): the wrapper raises on the rest.
The plain version is K1's (``_coarse_scores_plain`` without folding the
weight a second time, then ``_extract_topt_plain``). A CUDA tensor launches
the kernel or raises; a CPU tensor takes the plain version.

``python -m omni_recall_tpu_torch.tools.probe_pipe`` runs the tool's sweep
(N = 2^20, d = 768, B = 1536, t = 4, (c, sub) in (512, 512), (1024, 1024),
(1024, 512)) on the card (``--device cpu`` for the plain version) and prints
the tool's line for each. Then, as the tool does, it checks at (1024, 1024)
that the pipelined output equals K1's on the same inputs: K1's plain
version, so that the sweep launches no serving kernel. It ends with one JSON
line.
"""

from __future__ import annotations

import argparse
import json
import math

import torch

from omni_recall_tpu_torch.device import resolve_device
from omni_recall_tpu_torch.ops import cuda
from omni_recall_tpu_torch.ops.oracle import COSINE_WEIGHT
from omni_recall_tpu_torch.ops.scorer import (
    INT8_TILE_ROWS,
    _by_query_chunks,
    _check_cuda_operands,
    _coarse_scores_plain,
    _packed_mode,
    _ptr,
    _require_cpu,
    block_topt_int8_coarse_plain,
    quantize_queries_int8,
)
from omni_recall_tpu_torch.tools import bits_equal, device_name, median_ms

N, D, B, T = 1 << 20, 768, 1536, 4  # the tool's sweep
CONFIGS = ((512, 512), (1024, 1024), (1024, 512))  # (c, sub)
CHECK = (1024, 1024)  # the tool's correctness check against K1
WARPGROUPS = "TMA producer + 2 wgmma consumers + 2 extraction"


def _t1(n: int, c: int, sub: int, t: int) -> int:
    if sub <= 0 or c <= 0 or c % sub or n % c or not 1 <= t + 1 <= sub:
        raise ValueError(f"T2 needs c % sub == 0, N % c == 0 and 1 <= t + 1 <= sub, "
                         f"got N={n}, c={c}, sub={sub}, t={t}")
    return t + 1


def check_kernel_shape(n: int, d: int, sub: int, groups: int | None = None) -> None:
    """Raise for a layout the CUDA kernel does not take: K1's shapes (it
    takes fewer slices than the first CUDA design, which took sub % 64 == 0)
    and a positive group count."""
    if d % 16 or (sub % INT8_TILE_ROWS and INT8_TILE_ROWS % sub) \
            or n % max(sub, INT8_TILE_ROWS) or (groups is not None and groups < 1):
        raise ValueError(f"the CUDA T2 kernel needs d % 16 == 0, sub % {INT8_TILE_ROWS} == 0 "
                         f"or {INT8_TILE_ROWS} % sub == 0, N % max(sub, {INT8_TILE_ROWS}) == 0 "
                         f"and groups >= 1, got N={n}, d={d}, sub={sub}, groups={groups}")


def _tool_layout(vals, idxs, c: int, sub: int):
    """[B, N/sub, t1] -> the tool's [N/c, B, (c/sub)·t1] view."""
    b, slices, t1 = vals.shape
    shape = (b, slices * sub // c, (c // sub) * t1)
    return vals.reshape(shape).transpose(0, 1), idxs.reshape(shape).transpose(0, 1)


def pipe_scan(emb8, q8, add_row, scale_row, q_scale, q_bias, t: int, sub: int, c: int,
              groups: int | None = None):
    """T2 over the coarse scan's operands (``q_scale`` already carries the
    0.7 cosine weight). ``groups``: groups of max(sub, 128) rows a block of
    the CUDA kernel walks (None: K1's choice)."""
    n, b = emb8.shape[0], q8.shape[0]
    t1 = _t1(n, c, sub, t)
    if not emb8.is_cuda:
        _require_cpu(emb8)
        return pipe_scan_plain(emb8, q8, add_row, scale_row, q_scale, q_bias, t, sub, c)
    d = emb8.shape[1]
    check_kernel_shape(n, d, sub, groups)
    f32, i8 = torch.float32, torch.int8
    add_row, scale_row, q_scale, q_bias = (
        x.reshape(-1) for x in (add_row, scale_row, q_scale, q_bias))
    _check_cuda_operands(
        emb8.device, emb8=(emb8, i8, (n, d)), q8=(q8, i8, (b, d)),
        add_row=(add_row, f32, (n,)), scale_row=(scale_row, f32, (n,)),
        q_scale=(q_scale, f32, (b,)), q_bias=(q_bias, f32, (b,)),
    )
    vals = torch.empty((b, n // sub, t1), dtype=f32, device=emb8.device)
    idxs = torch.empty((b, n // sub, t1), dtype=torch.int32, device=emb8.device)
    lib = cuda.library("int8_scan")
    rc = lib.omni_int8_pipe_topt(
        _ptr(emb8), _ptr(q8), _ptr(add_row), _ptr(scale_row), _ptr(q_scale), _ptr(q_bias),
        _ptr(vals), _ptr(idxs), n, d, b, sub, t1, int(_packed_mode(sub, t1)),
        groups or 0, cuda.stream_ptr(emb8.device),
    )
    cuda.check(lib, rc, "probe_pipe")
    cuda.count_launch("probe_pipe")
    return _tool_layout(vals, idxs, c, sub)


def pipe_scan_plain(emb8, q8, add_row, scale_row, q_scale, q_bias, t: int, sub: int,
                    c: int):
    """Plain PyTorch T2: K1's plain scores and extraction, in the tool's
    layout."""
    t1 = _t1(emb8.shape[0], c, sub, t)
    vals, idxs = _by_query_chunks(
        lambda q8_, qs_, qb_, emb8_, ar_, sr_: _coarse_scores_plain(
            emb8_, q8_, ar_, sr_, qs_, qb_),
        (q8, q_scale, q_bias), (emb8, add_row, scale_row), sub, t1)
    return _tool_layout(vals, idxs, c, sub)


def query_tile(d: int, sub: int) -> int:
    """Queries one block of the CUDA kernel takes at width d and slice sub
    (its two [QT][max(sub, 128) + 4] f32 score slots stay in shared memory):
    32, or 16 at sub 1024 and d = 768, where K1 takes 32. Needs the built
    library (the card)."""
    return cuda.library("int8_scan").omni_int8_pipe_tile(sub, d)


def tool_inputs(n: int, b: int, device: torch.device, seed: int = 0):
    """The tool's operands: int8 rows in [-127, 127], scale 1/127/sqrt(d),
    zero add_row and q_bias, normal queries normalized and quantized.
    Returns (emb8, q8, add_row, scale_row, q_scale, q_bias) with q_scale as
    the quantizer gives it, before the 0.7 fold."""
    g = torch.Generator(device=device).manual_seed(seed)
    emb8 = torch.randint(-127, 128, (n, D), generator=g, device=device).to(torch.int8)
    q = torch.randn((b, D), generator=g, device=device)
    q8, q_scale, _ = quantize_queries_int8(q / q.norm(dim=1, keepdim=True))
    scale = torch.full((1, n), 1.0 / 127.0 / math.sqrt(D), device=device)
    return (emb8, q8, torch.zeros((1, n), device=device), scale, q_scale,
            torch.zeros((b, 1), device=device))


def main(n: int = N, device: str = "cuda", runs: int = 8) -> list[dict]:
    """The tool's sweep, each configuration timed as the median of ``runs``
    calls after a warm-up, then its check against K1. Prints the tool's
    lines, then one JSON line; returns the records (the check's launch is
    counted in its configuration's record)."""
    dev = resolve_device(device)
    emb8, q8, add_row, scale, q_scale_raw, q_bias = tool_inputs(n, B, dev)
    q_scale = COSINE_WEIGHT * q_scale_raw  # folded as the serving scan folds it
    records = []
    for c, sub in CONFIGS:
        before = cuda.LAUNCHES["probe_pipe"]
        ms = median_ms(lambda: pipe_scan(emb8, q8, add_row, scale, q_scale, q_bias,  # noqa: B023
                                         T, sub, c), dev, runs)  # noqa: B023
        label = f"P  pipelined scan c={c} sub={sub} t={T}"
        print(f"{label:52s} {ms:9.3f} ms/batch", flush=True)
        records.append({
            "c": c, "sub": sub, "t": T, "ms": ms, "qps": B / (ms / 1e3),
            "query_tile": query_tile(D, sub) if dev.type == "cuda" else None,
            "warpgroups": WARPGROUPS,
            "launches": cuda.LAUNCHES["probe_pipe"] - before,
        })
    # correctness: the pipelined scan against K1 (which folds 0.7 itself)
    c, sub = CHECK
    rec = records[CONFIGS.index(CHECK)]
    before = cuda.LAUNCHES["probe_pipe"]
    vals_p, idxs_p = pipe_scan(emb8, q8, add_row, scale, q_scale, q_bias, T, sub, c)
    rec["launches"] += cuda.LAUNCHES["probe_pipe"] - before
    vals_r, idxs_r = block_topt_int8_coarse_plain(emb8, q8, add_row, scale, q_scale_raw,
                                                  q_bias, t=T, sub=sub, block=c)
    rec["k1_vals_equal"] = bits_equal(vals_p.transpose(0, 1).reshape(vals_r.shape), vals_r)
    rec["k1_idxs_equal"] = bits_equal(idxs_p.transpose(0, 1).reshape(idxs_r.shape), idxs_r)
    print("vals equal:", rec["k1_vals_equal"], "idxs equal:", rec["k1_idxs_equal"], flush=True)
    print(json.dumps({"tool": "probe_pipe", "device": device_name(dev), "n": n, "d": D,
                      "b": B, "runs": runs, "records": records}), flush=True)
    return records


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    main(device=parser.parse_args().device)
