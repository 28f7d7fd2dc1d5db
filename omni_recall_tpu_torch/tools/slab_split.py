"""Where T3 spends its time: the kernel built in variant forms and timed.

T3 (``csrc/refine.cu`` ``refine_slab_kernel``) streams its slab rows through
a cp.async ring filled by producer warps while consumer warps run the int8
``mma.sync`` products, and it is bound by bytes. Without a profiler's
counters, this tool splits its time by building the source in several forms
(textual edits, each of which must match the source as many times as
stated) and timing every form on the same inputs at chip_smoke.py's three
T3 shapes (N = 2^20 planes, d = 768, W = 128; B = 1536 at m = 128 and
B = 448 at m = 64, qg 16; B = 448 at m = 512, qg 4), on K3's candidates
gathered as the tool gathers them. Three kinds of form:

- alternatives, which compute the same function (each held bitwise to the
  plain version): the producer warps a block (1, 2 and 4 against the
  committed 8), four consumer warps against the committed 8 (32-row stages,
  which hold K whole at d = 768 where the committed 64-row stages take it in
  two chunks) and a ring of two stages;
- diagnostics, which compute something else and say what a part costs:
  ``no_products`` (the consumers skip both product loops, so the ring, the
  barriers and the epilogue are left: the streaming alone), ``no_keyword``
  and ``no_planes``;
- ``counters``: the committed kernel with clock64 counters, read back by an
  entry of its own after one launch: for each producer warp the cycles spent
  waiting for an empty stage, issuing copies and waiting for them to land,
  for each consumer warp the cycles spent waiting for a full stage and
  working on it (products and epilogue); averages over the warps.

Every form is timed ``rounds`` times in turn (device time, CUDA events, a
device sleep queued first so the launches are all queued before the first
event), and its median is reported beside the committed form's. Prints one
JSON line a shape.

``python -m omni_recall_tpu_torch.tools.slab_split`` (needs nvcc and the
card).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess

import torch

from omni_recall_tpu_torch.ops import cuda, refine
from omni_recall_tpu_torch.tools import bits_equal, median_ms
from omni_recall_tpu_torch.tools import probe_serve as t3

N, D, BITS = 1 << 20, 768, 1024
SHAPES = {"tool": (1536, 128), "select": (448, 64), "qg4": (448, 512)}  # (B, m)
NOW = 365.0

_PRODUCERS = "constexpr int kSlabProducers = 8;"
_CONSUMERS = "constexpr int kSlabWarps = 8;"
_PLAN = ("stages = l.ring + 3 * l.stage <= kMaxSmem ? 3 : "
         "l.ring + 2 * l.stage <= kMaxSmem ? 2 : 0;")
_PLANES = "    for (int s = 0; s < ns; ++s) {"
_KEYWORD = "    for (int u = 0; u < nwc; ++u) {"

# the counters: 0-2 the producers' empty wait, issue and copy wait, 3 their
# warps; 4-5 the consumers' full wait and work, 6 their warps
_COUNTERS = [
    ("constexpr int kSlabMaxStages = 3;\n",
     "constexpr int kSlabMaxStages = 3;\n__device__ unsigned long long g_slab_clk[8];\n", 1),
    ("  for (int it = 0; it < iters; ++it) {\n"
     "    if (it >= a.stages) bar_sync(kBarEmpty + it % a.stages, kSlabThreads);\n"
     "    slab_issue(a, l, smem, it, rb_end, pw, lane);\n",
     "  unsigned long long clk[3] = {0, 0, 0}, t0;\n"
     "  for (int it = 0; it < iters; ++it) {\n"
     "    t0 = clock64();\n"
     "    if (it >= a.stages) bar_sync(kBarEmpty + it % a.stages, kSlabThreads);\n"
     "    clk[0] += clock64() - t0;\n"
     "    t0 = clock64();\n"
     "    slab_issue(a, l, smem, it, rb_end, pw, lane);\n"
     "    clk[1] += clock64() - t0;\n", 1),
    ("      if (ahead == 2) cp_async_wait<2>(); else cp_async_wait<1>();\n",
     "      t0 = clock64();\n"
     "      if (ahead == 2) cp_async_wait<2>(); else cp_async_wait<1>();\n"
     "      clk[2] += clock64() - t0;\n", 1),
    ("  for (int it = max(0, iters - ahead); it < iters; ++it)\n"
     "    bar_arrive(kBarFull + it % a.stages, kSlabThreads);\n",
     "  for (int it = max(0, iters - ahead); it < iters; ++it)\n"
     "    bar_arrive(kBarFull + it % a.stages, kSlabThreads);\n"
     "  if (lane == 0) {\n"
     "    for (int k = 0; k < 3; ++k) atomicAdd(&g_slab_clk[k], clk[k]);\n"
     "    atomicAdd(&g_slab_clk[3], 1ull);\n"
     "  }\n", 1),
    ("  int acc[4][4], kwacc[2][4];\n"
     "  for (int it = 0; it < iters; ++it) {\n"
     "    bar_sync(kBarFull + it % a.stages, kSlabThreads);\n",
     "  int acc[4][4], kwacc[2][4];\n"
     "  unsigned long long full = 0, work = 0, t1;\n"
     "  for (int it = 0; it < iters; ++it) {\n"
     "    t1 = clock64();\n"
     "    bar_sync(kBarFull + it % a.stages, kSlabThreads);\n"
     "    full += clock64() - t1;\n"
     "    t1 = clock64();\n", 1),
    ("      if (it + a.stages < iters) bar_arrive(kBarEmpty + it % a.stages, kSlabThreads);\n"
     "      continue;\n",
     "      work += clock64() - t1;\n"
     "      if (it + a.stages < iters) bar_arrive(kBarEmpty + it % a.stages, kSlabThreads);\n"
     "      continue;\n", 1),
    ("    if (it + a.stages < iters) bar_arrive(kBarEmpty + it % a.stages, kSlabThreads);\n"
     "  }\n}\n",
     "    work += clock64() - t1;\n"
     "    if (it + a.stages < iters) bar_arrive(kBarEmpty + it % a.stages, kSlabThreads);\n"
     "  }\n"
     "  if (lane == 0) {\n"
     "    atomicAdd(&g_slab_clk[4], full);\n"
     "    atomicAdd(&g_slab_clk[5], work);\n"
     "    atomicAdd(&g_slab_clk[6], 1ull);\n"
     "  }\n}\n", 1),
    ('extern "C" const char* omni_cuda_error_string(int code) {',
     '// the counters into dst (8 u64), then zeroed\n'
     'extern "C" int omni_slab_counters(void* dst) {\n'
     '  cudaError_t err = cudaMemcpyFromSymbol(dst, g_slab_clk, sizeof(g_slab_clk));\n'
     '  const unsigned long long zero[8] = {0, 0, 0, 0, 0, 0, 0, 0};\n'
     '  if (err == cudaSuccess) err = cudaMemcpyToSymbol(g_slab_clk, zero, sizeof(zero));\n'
     '  return (int)err;\n'
     '}\n\n'
     'extern "C" const char* omni_cuda_error_string(int code) {', 1),
]

# form -> (computes the kernel's function, [(old, new, matches)])
EDITS = {
    "committed": (True, []),
    "producers_1": (True, [(_PRODUCERS, _PRODUCERS.replace("8;", "1;"), 1)]),
    "producers_2": (True, [(_PRODUCERS, _PRODUCERS.replace("8;", "2;"), 1)]),
    "producers_4": (True, [(_PRODUCERS, _PRODUCERS.replace("8;", "4;"), 1)]),
    "consumers_4": (True, [(_CONSUMERS, _CONSUMERS.replace("8;", "4;"), 1)]),
    "stages_2": (True, [(_PLAN, _PLAN.replace("<= kMaxSmem ? 3", "< 0 ? 3"), 1)]),
    "no_products": (False, [(_PLANES, _PLANES.replace("s < ns", "s < 0"), 1),
                            (_KEYWORD, _KEYWORD.replace("u < nwc", "u < 0"), 1)]),
    "no_keyword": (False, [(_KEYWORD, _KEYWORD.replace("u < nwc", "u < 0"), 1)]),
    "no_planes": (False, [(_PLANES, _PLANES.replace("s < ns", "s < 0"), 1)]),
    "counters": (True, _COUNTERS),
}
COUNTER_NAMES = ("producer_empty_wait", "producer_issue", "producer_copy_wait",
                 "consumer_full_wait", "consumer_work")


def variant_source(src: str, form: str) -> str:
    for old, new, count in EDITS[form][1]:
        if src.count(old) != count:
            raise ValueError(f"{form}: {old!r} found {src.count(old)} times, expected {count}")
        src = src.replace(old, new)
    return src


def build() -> tuple[dict, ctypes._CFuncPtr]:
    """Compile every form (one nvcc each, all at once) and bind T3's entry
    with the committed interface; also the counters form's reader."""
    out = cuda.BUILD_DIR / "slab_split"
    out.mkdir(parents=True, exist_ok=True)
    src = (cuda.CSRC / cuda.SOURCES["refine"]).read_text()
    procs = {}
    for form in EDITS:
        cu, so = out / f"refine_{form}.cu", out / f"librefine_{form}.so"
        cu.write_text(variant_source(src, form))
        procs[form] = so, subprocess.Popen(
            [cuda.nvcc_path(), *cuda.NVCC_FLAGS, "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    fns, counters = {}, None
    for form, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on refine/{form}:\n{log}")
        lib = ctypes.CDLL(str(so))
        fn = lib.omni_refine_slab
        fn.restype, fn.argtypes = ctypes.c_int, cuda._ARGTYPES["refine"]["omni_refine_slab"]
        fns[form] = fn
        if form == "counters":
            counters = lib.omni_slab_counters
            counters.restype, counters.argtypes = ctypes.c_int, [ctypes.c_void_p]
    return fns, counters


def planes(dev: torch.device, g: torch.Generator) -> dict:
    """chip_smoke.py's kernel-phase index: random int8 planes and bloom,
    scales, error terms, created days and a 1% invalid mask."""
    w = BITS // 8
    return {
        "emb1": torch.randint(-127, 128, (N, D), generator=g, device=dev).to(torch.int8),
        "scale1": torch.rand((N,), generator=g, device=dev) * 1e-3 + 1e-3,
        "emb2": torch.randint(-127, 128, (N, D), generator=g, device=dev).to(torch.int8),
        "scale2": torch.rand((N,), generator=g, device=dev) * 1e-4,
        "err2": torch.rand((N,), generator=g, device=dev) * 4e-5,
        "bloom": torch.randint(0, 256, (N, w), generator=g, device=dev).to(torch.uint8),
        "created": torch.rand((N,), generator=g, device=dev) * 400.0,
        "valid": torch.rand((N,), generator=g, device=dev) > 0.01,
    }


def slab_operands(ix: dict, b: int, m: int, dev: torch.device, g: torch.Generator):
    """T3's operands for K3's candidates at (b, m) (``probe_serve.k3_slab_operands``)."""
    w = BITS // 8
    q = torch.randn((b, D), generator=g, device=dev)
    q /= q.norm(dim=1, keepdim=True)
    kw = torch.where(torch.rand((b, 8 * w), generator=g, device=dev) < 0.03,
                     torch.rand((b, 8 * w), generator=g, device=dev) * 0.1,
                     torch.zeros((), device=dev))
    rows = torch.randint(-1, N, (b, m), generator=g, device=dev).to(torch.int32)
    vals = torch.randn((b, m), generator=g, device=dev)
    return t3.k3_slab_operands(
        ix["emb1"], ix["scale1"], ix["emb2"], ix["scale2"], ix["err2"], ix["bloom"],
        ix["created"], ix["valid"], q, refine.quantize_kw_weights(kw),
        torch.rand((b,), generator=g, device=dev) * 0.05, NOW, rows, vals)


def shape_split(fns: dict, counters, ops, qg: int, dev: torch.device, rounds: int) -> dict:
    """Each form's output checked (a form that computes the function must
    match the plain version bit for bit), the counters' averages, and each
    form's device time: the median over ``rounds`` turns of all forms, each
    turn's time the median of 5 runs."""
    b, rows = ops[0].shape[0], ops[8].shape[0]
    d, w, m = ops[0].shape[1], ops[10].shape[1], rows // b
    out = torch.empty((b, qg * m), device=dev)

    def launch(fn):
        rc = fn(*[x.data_ptr() for x in ops], out.data_ptr(), b, d, w, m, qg,
                cuda.stream_ptr(dev))
        if rc:
            raise RuntimeError(f"T3 launch failed ({rc})")
        return out

    want = refine.refine_slab_tile_plain(*ops, qg)
    same = {}
    for form, fn in fns.items():
        same[form] = bits_equal(launch(fn), want)
        if EDITS[form][0] and not same[form]:
            raise AssertionError(f"refine/{form} disagrees with the plain version")
    clk = (ctypes.c_ulonglong * 8)()
    for run in range(2):  # the first read zeroes the counters, the second has one launch's
        torch.cuda.synchronize()
        if counters(ctypes.addressof(clk)):
            raise RuntimeError("reading T3's counters failed")
        if run == 0:
            launch(fns["counters"])
    warps = [max(clk[3], 1)] * 3 + [max(clk[6], 1)] * 2
    cycles = {name: clk[k + (k >= 3)] / warps[k] for k, name in enumerate(COUNTER_NAMES)}
    times = {f: [] for f in fns}
    for _ in range(rounds):
        for form, fn in fns.items():
            times[form].append(median_ms(lambda fn=fn: launch(fn), dev, 5, device_only=True))
    return {"ms": {f: statistics.median(t) for f, t in times.items()}, "same": same,
            "counters_cycles_per_warp": cycles}


def main(rounds: int = 5, seed: int = 0) -> list[dict]:
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    fns, counters = build()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    ix = planes(dev, g)
    lines = []
    for shape, (b, m) in SHAPES.items():
        ops, qg = slab_operands(ix, b, m, dev, g)
        bound, by = t3.slab_bound_ms(b, m, D, BITS // 8, qg)
        line = {"tool": "slab_split", "shape": shape, "b": b, "m": m, "d": D, "qg": qg,
                "bound_ms": bound, "bound_by": by,
                **shape_split(fns, counters, ops, qg, dev, rounds), "gpu": smi,
                "rounds": rounds}
        print(json.dumps(line), flush=True)
        lines.append(line)
        del ops
        torch.cuda.empty_cache()
    return lines


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--rounds", type=int, default=5)
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()
    main(args.rounds, args.seed)
