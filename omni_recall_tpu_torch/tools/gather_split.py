"""Where K2 and K3 spend their time: each built in variant forms and timed.

K2 (``csrc/dd_rows.cu``) and K3 (``csrc/refine.cu``) gather candidate rows by
index and run at under half their byte bound. Without a profiler's counters,
this tool splits their time by building each source in several forms
(textual edits, each of which must match the source as many times as
stated) and timing every form on the same inputs at the serving shapes
(N = 2^20, d = 768, W = 128; K2 at [448, 32], K3 at the select stage's
[448, 64] and the rescue stage's [64, 2048]). Two kinds of form:

- diagnostics, which compute something else and say what a part costs:
  K2 ``loads_only`` (the register levels' TwoSum folds replaced by one plain
  f32 sum a thread, so the loads, products, shuffle levels and stores are
  left) and K3 ``no_quantize`` (warp 0 skips the query's quantization);
- alternatives, which compute the same function (each held bitwise to the
  plain version, K2's sabs within SABS_REL): the block and tile constants
  the committed kernels chose (K2's warps a block and slots a warp; K3's
  warps a block, lanes a candidate and blocks an SM) and K3's ``division``,
  the quantizer dividing every element exactly instead of multiplying by
  the reciprocal and dividing only next to rounding ties.

Every form is timed ``rounds`` times in turn (device time, CUDA events, a
device sleep queued first so the launches are all queued before the first
event), and its median is reported beside the committed form's. Prints one
JSON line a kernel and shape.

``python -m omni_recall_tpu_torch.tools.gather_split`` (needs nvcc and the
card).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess

import torch

from omni_recall_tpu_torch.ops import cuda, exact_cos, refine
from omni_recall_tpu_torch.tools import bits_equal, median_ms

N, D, BITS, B, DD_T = 1 << 20, 768, 1024, 448, 32
REFINE_SHAPES = {"select": (448, 64), "rescue": (64, 2048)}
NOW = 365.0

_DD_WARPS = "constexpr int kBlockWarps = 4;"
_DD_SLOTS = "constexpr int kSlotsPerWarp = 2;"
_RF_WARPS = ("constexpr int kWarps = 4;", "__launch_bounds__(32 * kWarps, 4)")
_RF_LANES = "constexpr int kCandLanes = 8;"
_RF_BLOCKS = "constexpr int kBlocksPerSm = 3;"

# source -> form -> (computes the kernel's function, [(old, new, matches)])
EDITS = {
    "dd_rows": {
        "committed": (True, []),
        "loads_only": (False, [(
            "    fold_registers<R / 2>(h, l);\n",
            "    for (int i = 1; i < R; ++i) h[0] = __fadd_rn(h[0], h[i]);\n", 1)]),
        "block_warps_8": (True, [(_DD_WARPS, _DD_WARPS.replace("4", "8"), 1)]),
        "block_warps_16": (True, [(_DD_WARPS, _DD_WARPS.replace("4", "16"), 1)]),
        "slots_per_warp_1": (True, [(_DD_SLOTS, _DD_SLOTS.replace("2", "1"), 1)]),
        "slots_per_warp_4": (True, [(_DD_SLOTS, _DD_SLOTS.replace("2", "4"), 1)]),
    },
    "refine": {
        "committed": (True, []),
        "no_quantize": (False, [(
            "    quantize_query(a.q + (size_t)bi * a.d, a.d, xs, red, sq1, sq2, qterm, lane);\n",
            "    if (lane < 4) qterm[lane] = 0.0f;\n", 1)]),
        "division": (True, [
            ("      v[k] = rintf(qa);\n", "      v[k] = rintf(__fdiv_rn(x[k], safe));\n", 1),
            ("      if (!(tie >= kTie && fabsf(qa) <= 128.0f)) near |= 1u << k;\n", "", 1)]),
        "warps_2": (True, [(_RF_WARPS[0], _RF_WARPS[0].replace("4", "2"), 1),
                           (_RF_WARPS[1], _RF_WARPS[1].replace(", 4)", ", 8)"), 1)]),
        "warps_8": (True, [(_RF_WARPS[0], _RF_WARPS[0].replace("4", "8"), 1),
                           (_RF_WARPS[1], _RF_WARPS[1].replace(", 4)", ", 2)"), 1)]),
        "cand_lanes_16": (True, [(_RF_LANES, _RF_LANES.replace("8", "16"), 1)]),
        "blocks_per_sm_2": (True, [(_RF_BLOCKS, _RF_BLOCKS.replace("3", "2"), 1)]),
        "blocks_per_sm_4": (True, [(_RF_BLOCKS, _RF_BLOCKS.replace("3", "4"), 1)]),
    },
}


def variant_source(src: str, source: str, form: str) -> str:
    for old, new, count in EDITS[source][form][1]:
        if src.count(old) != count:
            raise ValueError(f"{source}/{form}: {old!r} found {src.count(old)} times, "
                             f"expected {count}")
        src = src.replace(old, new)
    return src


def build() -> dict[tuple[str, str], ctypes._CFuncPtr]:
    """Compile every form (one nvcc each, all at once) and bind its entry
    point with the committed interface."""
    out = cuda.BUILD_DIR / "gather_split"
    out.mkdir(parents=True, exist_ok=True)
    entry = {"dd_rows": "omni_dd_rows", "refine": "omni_refine"}
    procs = {}
    for source, forms in EDITS.items():
        src = (cuda.CSRC / cuda.SOURCES[source]).read_text()
        for form in forms:
            cu, so = out / f"{source}_{form}.cu", out / f"lib{source}_{form}.so"
            cu.write_text(variant_source(src, source, form))
            procs[source, form] = so, subprocess.Popen(
                [cuda.nvcc_path(), *cuda.NVCC_FLAGS, "-o", str(so), str(cu)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    fns = {}
    for (source, form), (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {source}/{form}:\n{log}")
        fn = getattr(ctypes.CDLL(str(so)), entry[source])
        fn.restype, fn.argtypes = ctypes.c_int, cuda._ARGTYPES[source][entry[source]]
        fns[source, form] = fn
    return fns


def split(source: str, fns: dict, launch, check, dev: torch.device, rounds: int) -> dict:
    """Each form's output checked (``check``: a form that computes the
    function must pass it) and its device time, the median over ``rounds``
    turns of all forms, each turn's time the median of 5 runs."""
    forms = {f: (lambda fn=fns[source, f]: launch(fn)) for f in EDITS[source]}
    same = {}
    for form, go in forms.items():
        same[form] = check(go())
        if EDITS[source][form][0] and not same[form]:
            raise AssertionError(f"{source}/{form} disagrees with the plain version")
    times = {f: [] for f in forms}
    for _ in range(rounds):
        for form, go in forms.items():
            times[form].append(median_ms(go, dev, 5, device_only=True))
    return {"ms": {f: statistics.median(t) for f, t in times.items()}, "same": same}


def dd_split(fns: dict, dev: torch.device, g: torch.Generator, rounds: int) -> dict:
    raw = torch.randn((N, D), generator=g, device=dev) / D ** 0.5
    q = torch.randn((B, D), generator=g, device=dev) / D ** 0.5
    rows = torch.randint(-1, N, (B, DD_T), generator=g, device=dev).to(torch.int32)
    want = exact_cos.exact_cos_rows_plain(raw, rows, q)
    hi, lo, sabs = (torch.empty((B, DD_T), device=dev) for _ in range(3))

    def launch(fn):
        rc = fn(raw.data_ptr(), rows.data_ptr(), q.data_ptr(), hi.data_ptr(), lo.data_ptr(),
                sabs.data_ptr(), N, D, B, DD_T, cuda.stream_ptr(dev))
        if rc:
            raise RuntimeError(f"dd_rows launch failed ({rc})")
        return hi, lo, sabs

    def check(got):
        rel = float(((got[2] - want[2]).abs() / want[2].abs().clamp_min(1e-30)).max())
        return bits_equal(got[0], want[0]) and bits_equal(got[1], want[1]) and \
            rel <= exact_cos.SABS_REL

    return {"kernel": "dd_rows", "shape": [B, DD_T, D],
            **split("dd_rows", fns, launch, check, dev, rounds)}


def refine_split(fns: dict, dev: torch.device, g: torch.Generator, rounds: int) -> list[dict]:
    w = BITS // 8
    emb1 = torch.randint(-127, 128, (N, D), generator=g, device=dev).to(torch.int8)
    emb2 = torch.randint(-127, 128, (N, D), generator=g, device=dev).to(torch.int8)
    bloom = torch.randint(0, 256, (N, w), generator=g, device=dev).to(torch.uint8)
    scale1 = torch.rand((N,), generator=g, device=dev) * 1e-3 + 1e-3
    scale2 = torch.rand((N,), generator=g, device=dev) * 1e-4
    err2 = torch.rand((N,), generator=g, device=dev) * 4e-5
    created = torch.rand((N,), generator=g, device=dev) * 400.0
    valid = torch.rand((N,), generator=g, device=dev) > 0.01
    lines = []
    for stage, (b, m) in REFINE_SHAPES.items():
        q = torch.randn((b, D), generator=g, device=dev)
        q /= q.norm(dim=1, keepdim=True)
        kw_w8 = torch.where(
            torch.rand((b, 8 * w), generator=g, device=dev) < 0.03,
            torch.randint(1, 128, (b, 8 * w), generator=g, device=dev).to(torch.int8),
            torch.zeros((), dtype=torch.int8, device=dev))
        kw_b = torch.rand((b,), generator=g, device=dev) * 0.05
        rows = torch.randint(-1, N, (b, m), generator=g, device=dev).to(torch.int32)
        vals = torch.randn((b, m), generator=g, device=dev)
        want = refine.refine_bounds_plain(emb1, scale1, emb2, scale2, err2, bloom, created,
                                          valid, q, kw_w8, kw_b, NOW, rows, vals)
        out = torch.empty((b, m), device=dev)

        def launch(fn, q=q, kw_w8=kw_w8, kw_b=kw_b, rows=rows, vals=vals, out=out, b=b, m=m):
            rc = fn(emb1.data_ptr(), emb2.data_ptr(), bloom.data_ptr(), scale1.data_ptr(),
                    scale2.data_ptr(), err2.data_ptr(), valid.data_ptr(), created.data_ptr(),
                    q.data_ptr(), kw_w8.data_ptr(), kw_b.data_ptr(), rows.data_ptr(),
                    vals.data_ptr(), out.data_ptr(), NOW, N, D, w, b, m, m, m,
                    cuda.stream_ptr(dev))
            if rc:
                raise RuntimeError(f"refine launch failed ({rc})")
            return out

        lines.append({"kernel": f"refine[{stage}]", "shape": [b, m, D],
                      **split("refine", fns, launch,
                              lambda got, want=want: bits_equal(got, want), dev, rounds)})
    return lines


def main(rounds: int = 5, seed: int = 0) -> list[dict]:
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    fns = build()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    lines = [dd_split(fns, dev, g, rounds)]
    torch.cuda.empty_cache()
    lines += refine_split(fns, dev, g, rounds)
    for line in lines:
        line.update(tool="gather_split", gpu=smi, rounds=rounds)
        print(json.dumps(line), flush=True)
    return lines


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--rounds", type=int, default=5)
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()
    main(args.rounds, args.seed)
