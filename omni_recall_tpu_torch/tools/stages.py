"""What the serving-stage probes share: the synthetic int8 index they time,
the stage timer and each stage's least time on the card.

A stage's record holds ``ms``, the median of ``runs`` CUDA-event timings of
the stage after a warm-up with a ~10 ms device sleep queued first (the
device's own time: every launch of the stage is queued before its start
event), ``host_ms``, the median host-clock time of the stage with a
``synchronize`` after each call (what a caller waits, host work included),
its ``bound_ms`` and ``bound_by``, and the launches of the port's kernels
its timed calls made. On the CPU both times are the host clock.

The bound is the larger of the bytes the stage must move (each input read
once, each output written once) over the H100's 3.35 TB/s and its
operations over the peak rate of their type: 1979 T int8 operations/s on
the tensor cores, 67 T f32 operations/s outside them (NVIDIA's data sheet,
SXM part, at its 700 W limit).
"""

from __future__ import annotations

import torch

from omni_recall_tpu_torch.ops import cuda
from omni_recall_tpu_torch.utils.profiling import host_median_ms, median_ms

HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1.979e15
F32_OPS_PER_S = 67e12
NOW_DAYS = 365.0


def bound_ms(moved: float, ops: float = 0.0, rate: float = F32_OPS_PER_S) -> tuple[float, str]:
    t_bytes = moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def time_stage(name: str, label: str, fn, device: torch.device, runs: int,
               work: tuple[float, float, float], **extra) -> dict:
    """Time ``fn`` as one stage; ``work`` is (bytes, operations, rate)."""
    before = dict(cuda.LAUNCHES)
    ms = median_ms(fn, device, runs, device_only=device.type == "cuda")
    host_ms = host_median_ms(fn, runs, sync=device.type == "cuda")
    bms, by = bound_ms(*work)
    rec = {"stage": name, "label": label, "ms": ms, "host_ms": host_ms, "bound_ms": bms,
           "bound_by": by, **extra,
           "launches": {k: v - before[k] for k, v in cuda.LAUNCHES.items() if v != before[k]}}
    print(f"{label:52s} {ms:9.3f} ms  host {host_ms:9.3f} ms  bound {bms:8.4f} ms ({by})",
          flush=True)
    return rec


def all_same(xs, ys) -> bool:
    """Each pair of tensors bitwise equal (``tools.bits_equal``)."""
    from omni_recall_tpu_torch.tools import bits_equal

    return all(bits_equal(x, y) for x, y in zip(xs, ys, strict=True))


# ---- the synthetic index and queries ----


def unit_rows(n: int, d: int, g: torch.Generator, device, slab: int = 1 << 18) -> torch.Tensor:
    """n standard normal rows of d, each scaled to unit length."""
    out = torch.empty((n, d), device=device)
    for lo in range(0, n, slab):
        r = torch.randn((min(slab, n - lo), d), generator=g, device=device)
        out[lo:lo + r.shape[0]] = r / r.norm(dim=1, keepdim=True)
    return out


def int8_index(n: int, d: int, bits: int, device, seed: int = 0, refine: bool = False,
               raw: bool = False, sparse_bloom: bool = False) -> dict:
    """A quantized index of n unit rows (``device_quantize``: emb, scale,
    err and, with ``refine``, the residual plane emb2, scale2, err2), random
    bloom bytes (``sparse_bloom``: the AND of two draws, a quarter of the
    bits set), created days spread over a year, every row valid, and with
    ``raw`` the f32 rows themselves."""
    from omni_recall_tpu_torch.index.device_index import device_quantize

    g = torch.Generator(device=device).manual_seed(seed)
    rows = unit_rows(n, d, g, device)
    index = device_quantize(rows, refine=refine)
    w = bits // 8
    bloom = torch.randint(0, 256, (n, w), generator=g, device=device, dtype=torch.uint8)
    if sparse_bloom:
        bloom &= torch.randint(0, 256, (n, w), generator=g, device=device, dtype=torch.uint8)
    index.update(bloom=bloom, created=torch.linspace(0.0, 365.0, n, device=device),
                 valid=torch.ones((n,), dtype=torch.bool, device=device))
    if raw:
        index["raw"] = rows
    else:
        del rows
    return index


def queries(b: int, d: int, bits: int, device, seed: int = 3, kw_density: float = 0.04,
            kw_value: float = 0.025) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(q [b, d] unit rows, keyword weights [b, bits]: ``kw_value`` at about
    ``kw_density`` of the bits, zero bias [b])."""
    g = torch.Generator(device=device).manual_seed(seed)
    q = unit_rows(b, d, g, device)
    kw = torch.where(torch.rand((b, bits), generator=g, device=device) < kw_density,
                     torch.full((), kw_value, device=device), torch.zeros((), device=device))
    return q, kw, torch.zeros((b,), device=device)


# ---- each stage's work: (bytes moved, operations, rate) ----


def scan_out_bytes(n: int, b: int, sub: int, t1: int) -> int:
    return b * (n // sub) * t1 * 8


def coarse_work(n: int, b: int, d: int, sub: int, t1: int):
    """K1: the int8 rows, both per-row terms and the queries read once, the
    [B, N/sub, t1] values and indices written once; 2 int8 operations a
    product term."""
    return (n * d + 8 * n + b * d + 8 * b + scan_out_bytes(n, b, sub, t1),
            2.0 * n * d * b, INT8_OPS_PER_S)


def fused_work(n: int, b: int, d: int, w: int, sub: int, t1: int):
    """K4: K1's reads plus the bloom rows and the int8 keyword weights; the
    keyword dot is an int8 product over 8W bit columns."""
    return (n * d + n * w + 8 * n + b * d + 8 * w * b + 12 * b
            + scan_out_bytes(n, b, sub, t1), 2.0 * n * b * (d + 8 * w), INT8_OPS_PER_S)


def merge_work(b: int, slices: int, t1: int, m: int):
    """The merge to the top-(m+1): the emit read once, the [B, m+1] values
    and indices written once."""
    return b * slices * t1 * 8 + b * (m + 1) * 8, 0.0, F32_OPS_PER_S


def add_row_work(n: int):
    """The per-row term: created, valid and the error term read, the row
    written; about ten f32 operations a row."""
    return 13.0 * n, 10.0 * n, F32_OPS_PER_S


def query_work(b: int, d: int, bits: int):
    """The queries' quantization and keyword cap: f32 rows and weights read,
    int8 rows and three f32 terms written; about eight f32 operations an
    element."""
    return 4.0 * b * d + 4.0 * b * bits + b * d + 12.0 * b, 8.0 * b * (d + bits), F32_OPS_PER_S


def refine_work(b: int, m: int, d: int, w: int, uniq: int):
    """K3: each distinct candidate row's two int8 rows, bloom row and four
    f32 sidecars once, per slot its row id, scan bound and output, per query
    its f32 row, keyword weights and bias; four int8 dots of d and a
    keyword dot of 8W a slot (chip_smoke.py's K3 line)."""
    slots = b * m
    return (uniq * (2 * d + w + 17) + slots * 12 + b * (4 * d + 8 * w + 4),
            slots * (8.0 * d + 16.0 * w), INT8_OPS_PER_S)


def dd_work(b: int, t: int, d: int):
    """K2: each pair's f32 row and the queries read once, the row ids read
    and three f32 outputs written; 2d products and sums plus the
    double-float tree (14 operations a level) a pair."""
    pairs = b * t
    p2 = 1 << (d - 1).bit_length()
    return (pairs * d * 4 + b * d * 4 + pairs * 4 + 3 * pairs * 4,
            pairs * (2.0 * d + 14.0 * (p2 - 1)), F32_OPS_PER_S)


def gather_work(rows: int, row_bytes: int):
    """A gather of ``rows`` rows: each read once and written once."""
    return 2.0 * rows * row_bytes, 0.0, F32_OPS_PER_S


def select_work(b: int, m: int, k: int):
    """A top-k co-sort of [B, m] values and payloads: read once, k written."""
    return b * m * 8.0 + b * k * 8.0, 0.0, F32_OPS_PER_S


def total(*works):
    """The work of stages run one after another: their bytes, and their
    operations' times at their own rates (given as int8 operations)."""
    moved = sum(w[0] for w in works)
    t_ops = sum(w[1] / w[2] for w in works)
    return moved, t_ops * INT8_OPS_PER_S, INT8_OPS_PER_S


def unique_rows(rows: torch.Tensor) -> int:
    return int(torch.unique(rows.clamp_min(0)).numel())
