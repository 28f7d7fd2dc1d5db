#!/usr/bin/env python3
"""On-card check of the PyTorch + CUDA port (omni_recall_tpu_torch) on one
NVIDIA H100: ``python3 chip_smoke.py [--seed N] [--parent DIR]`` from the
repository root.

Phases, one JSON line each:

1. ``env``      torch / CUDA / nvcc versions, the card's name and power limit,
                and the build of every CUDA kernel from omni_recall_tpu_torch/csrc.
2. ``kernel``   per kernel (K1 coarse scan and its pair mode K7a, K2 DD
                cosine, K3 refine, K4 fused scan, K5 keyword scan, K6 f32/bf16
                scan on bf16 and on f32 rows), at the serving shapes
                (N = 2^20 rows, d = 768, 1024 bloom bits, B = 448 queries; K2
                at 32 candidates per query; K3 at 64 per query, the select
                stage, and at 64 x 2048, the rescue stage, also given its
                rows and scan bounds as column slices of a wider tensor,
                and its recency term's exp alone against torch.exp on every
                f32 argument <= 0 and the term against PyTorch's over every
                row of three 2^20-row indexes; K6 at sub 512,
                t 4, the engine's layout at m = 128): the kernel against its
                plain PyTorch version on the same inputs on the card (K2
                also through its gathered entry, ``dd_rows(q_raw, c)``,
                bitwise to the by-index entry on the same rows) —
                bitwise, K2's sabs within SABS_REL, K6 and T1 (tensor-core
                sums in the hardware's order) under the parity rule of
                ops/scorer.py fp_order_bound: bitwise on exactly-summable
                inputs, within the bound elsewhere with equal indices in
                every clear slice (over 75% of them) and sound against a
                float64 scan of sampled queries — and the median of 5
                CUDA-event timed runs of each (K6's plain version, which
                takes seconds, timed by the host clock over its one
                comparison call), beside the least time the card could
                take. K1, K7a and K4 (csrc/int8_scan.cu, int8 wgmma) carry
                the int8 cosine product alone (``torch._int_mm``) as their
                yardstick, K5 (int8_scan.cu too) the keyword product alone
                over the pre-expanded bit matrix, and K5's line also times
                it at slices of 512, where it takes its 64-query tile. Then
                the plain-torch xla scorer (no kernel of the
                repository) at the same shape: its time beside its f32 floor,
                its values against a float64 scan of a few queries. Then the
                two profiling probes of tools/ at the same serving shapes:
                T1 (tools/profile_kernel.py: K6's body as cosine only, cosine
                + keyword, and the full top-9, blocks of 1024 rows, bf16
                rows, sparse keyword weights) and T5 (tools/profile_bloomT.py:
                K4's body, slice maxima, on row and transposed bloom, which
                must agree bitwise), each against its plain version,
                with one PyTorch call's time as a yardstick where one computes
                the product at its heart. Then the two variants of K1 in
                tools/, both on K1's tiles in csrc/int8_scan.cu: T2
                (tools/probe_pipe.py: K1 with its extraction one group behind
                the dot) at K1's serving layout (sub 1024, t 2) and at the
                tool's (512, 512, t 4), bitwise against its plain version and
                against K1's kernel, with K1, K1 at t = 0 and T2 at t = 0
                timed beside it; and T4 (tools/probe_keys_emit.py: K1's tiles
                with the tool's bare epilogue) in its three emit layouts at
                c = sub = 1024, t1 = 3, each bitwise against its plain
                version, P3 decoded against pair's values. Given ``--parent
                DIR`` (the root of an earlier checkout, a ``git archive`` of
                the parent commit), that checkout's K2 (csrc/dd_rows.cu) and
                K3 (csrc/refine.cu, given the recency term it took from
                outside), built with this checkout's flags, on the same
                inputs, timed before and after the kernel (parent, kernel,
                kernel, parent), and its output held to the kernel's (K3
                bitwise, K2's hi and lo bitwise and sabs within SABS_REL):
                ``parent_ms``, ``ms_after``, ``parent_ms_after`` and
                ``parent_bitwise`` in the K2 and K3 lines. Last, T3
                (tools/probe_serve.py: K3's body over pre-gathered slabs,
                the whole [qg, qg·m] tile) on K3's candidates at the tool's
                shape (B = 1536, m = 128, qg 16) and at K3's select shape
                (448, 64, qg 16): bitwise against its plain version, its
                block diagonal bitwise against K3's kernel, timed beside K3
                and the tool's gathers at the same shape.
2b. ``profile`` the profiling path: the four tools' own sweeps
                (``omni_recall_tpu_torch.tools.profile_kernel.main("all")``,
                ``...profile_bloomT.main()``, ``...probe_pipe.main()``,
                ``...probe_keys_emit.main()``) at the tools' shapes, each
                configuration beside its bound. It must launch every probe but
                T3 and no serving kernel; no serving path may launch a probe.
2c. ``probe_serve`` the serving-stage decomposition
                (``omni_recall_tpu_torch.tools.probe_serve.main()``: S, SR, SR
                without DD, DD, G, K, T, Q and R at N = 2^20, B = 1536,
                m = 128). It must launch T3, K1, K3 and K2 and nothing else.
3. ``server``   the app of ``python -m omni_recall_tpu_torch.server`` in
                process on the card (Backend=pallas, int8, Refine=true,
                DirectSelect=true, Hash embeddings, Storage:SnapshotDir in
                a temporary directory): three uploads, five searches, each
                equal to the oracle-backend response; POST /api/chat twice:
                through an app sharing the store and engine with a scripted
                chat client injected as its chat_router (the answer's
                citations must be the recall's [1] and [2]), and through the
                default remote chain, which has no keys and must answer the
                reference's recall-only fallback; GET
                /swagger/v1/swagger.json, /swagger and /; then POST
                /api/snapshot, and a second app on the same directory must
                restore the same documents and chunks by the slab route and
                answer a search as the first did.
4. ``serve``    a 2^20 x 768 clustered corpus bulk-loaded into the headline
                index, DeviceIndex(scan_dtype="int8", refine=True,
                exact_cos=True) — the repository bench's configuration —
                served in batches of 448 through RecallEngine.search_batch
                and again through search_batches_pipelined; a sample of every
                batch is checked against the exact float64 host scan
                (DTO-identical). Then batches with the refine selection
                (DirectSelect off: K3 every batch), one in which one query in
                eight is keyword-led (its certificate misses, so the rescue
                loop's K4 and K3 serve it), one in K1's pair mode (K7a), one
                with the coarse prepass off (K4 + K3 serve every query) and
                one of empty-vector queries (K5, with its dispatch / device
                wait / finalize split). Last, the same corpus in an
                index without the residual planes (refine=False, the capacity
                configuration) serves a keyword-led batch: its rescue runs
                without K3. Before that, the ``sharded`` path (4i). Then
                the same corpus in three more indexes, each
                freed before the next, served in batches of 448 with an
                oracle sample: bf16 storage under the pallas backend (the
                bench's bf16 mode: K6), f32 storage (K6), and EngineOptions()
                with only the corpus keys set (the reference's defaults:
                backend xla over f32 storage, no kernel of the repository).
4i. ``sharded`` the same corpus in a second headline engine whose index is
                row-sharded over 4 shards of the card (``shards_mesh(devices=
                [cuda:0] * 4)``, parallel/): warm-up, 3 timed embedding
                batches (each shard's K1, then refine_select_dd: K3 and K2's
                gathered entry on every shard), a keyword-led batch (the
                shards' K4 rescue) and an empty-vector batch (K5); every DTO
                equal to the single-device engine's and an oracle sample of
                each batch; p50 and certified QPS beside the single-device
                engine's. Then ``tools.sharded_check``'s op parity over the
                headline planes on a one-shard mesh (bitwise) and the 4-shard
                mesh at the same (sub, t) (top-m values and boundary bitwise,
                a sound boundary, refine_select_dd bitwise); the two 10M-row
                tests of tests/test_sharded.py on 8 shards of the card; a
                one-rank NCCL group's collectives against the in-process
                ones (bitwise); and the ``probe_sharded_timing`` path (the
                tool at 2^20 rows on the 4-shard mesh: K7a alone).
4b. ``snapshot`` (paths ``snapshot`` and ``rebuild``) a 2^17-row headline
                index (the serve corpus's recipe, refine planes, device-exact
                cosine, rows going round eight documents of a store): saved
                (its device planes read back), loaded and restored into a
                fresh engine, which must take the slab route and serve the
                source's batches DTO for DTO; a copy with its error-bound
                plane zeroed must take the rebuild and serve the same. Then
                one document is deleted from the restored engine and
                ``rebuild_index`` must compact its planes on the device,
                bitwise equal to a fresh index of the surviving chunks. Save,
                load, restore, upload and rebuild seconds and chunks/s. Then
                the rebuild's stages on the restored store
                (``omni_recall_tpu_torch.tools.probe_rebuild``, path
                ``probe_rebuild``: fetch, append, two uploads, a rebuild that
                derives every row, one that compacts on the card; no kernel).
4d. ``localq`` the self-contained deployment (Embeddings:Provider=Local): the
                full-width encoder (vocab 32768, d_model 256, 4 layers, out
                768, bf16 compute) at its seed-0 init embeds 2^20 chunk texts
                ("topic c{k}x note r{i}", ~24 rows a cluster token) into the
                headline index; the app attaches it to the engine. A mixed
                batch (device-embedded and explicit vectors through K1 and
                K2, empty vectors through K5; ``localq_mixed``), then the
                first 16 queries of a text-only batch ("c{k}x r{i}") through
                the device-resident query pipeline, split. Then the bench's
                fine-tune of the same encoder (600 steps of 256 pairs
                "c{k}x" -> content), the corpus re-embedded, the index
                reloaded and the whole batch of 448 served again, split
                (``localq_trained``). A sample of each batch DTO-identical to
                the exact float64 scan of every row fed the bits the
                engine's forward materialized. The forward's time a batch,
                the corpus encode rate, and for both weights certified QPS,
                the batch's time, the resolved share at the prepass and in
                all, escalations, host scans.
4f. ``train``   the encoder's training: a small config's first 5 steps on the
                card against the port's CPU path (losses within the CPU
                tests' tolerances), a repeat of its 20-step fine-tune
                (bitwise or not, printed), then ``POST /api/documents/train``
                on an app with the local encoder and the headline engine
                over 2^14 uploaded chunks (documents of 32): step ms (CUDA
                events), losses, peak memory, train and reindex seconds,
                recall@10 of the known cluster before and after (64
                searches), 8 searches after DTO-identical to the float64
                scan of the stored vectors.
4g. ``chat_local`` Ai:Provider=Local (the seed-0 decoder) with the local
                encoder: 8 concurrent ``POST /api/chat`` through the
                continuous batcher (4 slots, 16-token chunks); every stream
                bit for bit the card's ``generate`` for its prompt; prefill
                ms at the buckets 128 / 256 / 512, the decode chunk's ms a
                step and tokens/s at 4 live slots.
4h. ``probe_localq`` ``omni_recall_tpu_torch.tools.probe_localq`` at the
                bench's default (2^16 rows, its small encoder fine-tuned):
                warm-ups, three split batches of 1536 with the host helpers'
                timers, six pipelined.
4e. ``bench_ingest`` the append pipeline at 50k chunks
                (``omni_recall_tpu_torch.tools.bench_ingest``): append and
                upload for f32 and int8 storage, chunks/s; no kernel.
4j. ``eval``   the eval path (omni_recall_tpu_torch/eval): the eval CLI's
                in-process app on the card with the headline's engine
                options (``headline_options``) and Hash embeddings at 768
                dims and 1024 bloom bits, the real corpus's 42 documents
                uploaded through POST /api/documents/upload, the generated
                cases through ``EvalHarness`` and ``InProcessClient``, every
                recall response equal to an oracle-backend app's on the
                same store; the 200-case parity campaign of eval/corpus.py
                at the JAX test's engine (d 64, 256 bits, m 16, capacity
                512) and with the headline's features at d 768 / 1024 bits,
                DTO-identical to the oracle; the real corpus's quality
                campaign (none, hash, local-untrained, local-trained at 300
                steps) on the card, every query also through the int8
                engine at d 64 / 256 bits (hits equal to the oracle's), and
                its fine-tuned provider on this machine's CPU in a process
                beside it (the same rendering of the documents), the
                fine-tuned recall within 0.03 of the CPU run's. The path
                must launch K1, K2, K3, K4 and K5. Its line carries the
                ``eval_trace`` path's result:
                ``utils/profiling.device_trace`` around one headline batch
                of the serve corpus (in phase 4, while the direct gate is
                open), the trace naming K1's and K2's kernels, and its five
                longest device operations.
4k. ``decomp`` the six stage probes of tools/ (``main()`` of
                omni_recall_tpu_torch/tools/{profile_int8, sweep_coarse,
                probe_scan_decomp, profile_refine, probe_direct_serve,
                probe_gather_sorted} at their defaults: 2^20 x 768, B 1536
                where the tool says so): each stage's CUDA-event device
                time beside its host clock and its bound; each tool holds
                its stages bitwise against the whole path they split, and
                the sorted gather un-permuted against the random one. The
                path launches K1, K7a, K4, K3 and K2 and no probe kernel.
4c. ``compact`` the compact 10M store of the repository bench (10 x 2^20 x
                768 rows, 512 bloom bits, batches of 896, kw_frac 0.75,
                ``bench.py st_10m``), built by ``build_compact_engine`` after
                the earlier paths' engines are freed: host build and device
                fill seconds, host store bytes, every device plane bitwise
                against the host columns slab by slab, two timed batches
                and one split (dispatch / device wait / finalize), four
                queries a batch DTO-identical to an exact float64 scan of
                every row (``compact_exact_scan``); K1, K4 and K5 over the
                whole plane at W = 64, bitwise to their plain versions slab
                by slab, each timed beside its bound (K1 also beside
                ``torch._int_mm``); and the card's peak allocation. Then
                ``sweep_10m`` (``omni_recall_tpu_torch.tools.sweep_10m`` on
                these planes): K1 and the coarse entry at B in {448, 896,
                1536} and (sub, t) in {512, 1024} x {2, 4}.
5. ``kernels``  per kernel: its parity and times, and its launches on each
                path (the profiling path, the server of phase 3, each path
                of phase 4, ``eval``, ``eval_trace`` and ``decomp``; the
                counts are zeroed just before a path and read just after
                it, and each path must launch its kernels); T1, T2,
                T4 and T5 with one sub-entry per variant, layout or emit; T3
                with its select-shape line and the stage times; K1, K4 and
                K5 each with its line at the compact shape.

The last line is {"ok": true, "device": {...}}. Any failure raises and the
script exits non-zero; it needs CUDA and the repository beside it.
"""

from __future__ import annotations

import argparse
import contextlib
import datetime
import json
import os
import statistics
import subprocess
import sys
import time
import warnings

HERE = os.path.dirname(os.path.abspath(__file__))

N_ROWS = 1 << 20
DIM = 768
BITS = 1024
BATCH = 448
DD_T = 32
HBM_BYTES_PER_S = 3.35e12     # H100 SXM, NVIDIA data sheet
INT8_OPS_PER_S = 1.979e15     # dense int8 tensor-core peak
BF16_OPS_PER_S = 0.989e15     # dense bf16 tensor-core peak
F32_OPS_PER_S = 67e12         # f32 outside the tensor cores


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, runs: int = 5, device_only: bool = False) -> float:
    """Median of ``runs`` CUDA-event timings of fn() after one warm-up
    (``utils/profiling.cuda_median_ms``). ``device_only``: a 10 ms device
    sleep is queued first, so fn's launches are all queued before its events
    start and the time is the device's alone; without it a launch that takes
    less time on the device than on the host is timed at its host launch
    overhead."""
    from omni_recall_tpu_torch.utils.profiling import cuda_median_ms

    return cuda_median_ms(fn, runs, device_only)


def bitwise(a, b) -> bool:
    import torch

    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.dtype == torch.float32:
        return torch.equal(a.view(torch.int32), b.view(torch.int32))
    return torch.equal(a, b)


def bitwise_parity(ok: bool) -> str:
    """A kernel line's parity where the rule is bit for bit."""
    return "bitwise" if ok else "FAILED"


def bound_ms(bytes_moved: float, ops: float, ops_rate: float) -> tuple[float, str]:
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------- phase 2


class ParentBuild:
    """The parent's K2 and K3, for the same-call A/B: csrc/dd_rows.cu and
    csrc/refine.cu of an earlier checkout (the root DIR of ``--parent``),
    compiled with this checkout's flags into _build/parent/ and bound with
    the parent's C interfaces: ``omni_dd_rows`` as here, ``omni_refine`` with
    the recency term passed in and contiguous rows and scan bounds. Their
    nvcc processes start when this is made, beside the build of this
    checkout's kernels; ``load`` waits for them."""

    def __init__(self, root: str):
        from omni_recall_tpu_torch.ops import cuda

        out = cuda.BUILD_DIR / "parent"
        out.mkdir(parents=True, exist_ok=True)
        self.paths, self.procs, self.libs = {}, {}, {}
        for name in ("dd_rows", "refine"):
            src = os.path.join(root, "omni_recall_tpu_torch", "csrc", f"{name}.cu")
            self.paths[name] = out / f"lib{name}.so"
            self.procs[name] = subprocess.Popen(
                [cuda.nvcc_path(), *cuda.NVCC_FLAGS, "-o", str(self.paths[name]), src],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)

    def load(self) -> None:
        import ctypes

        p, i = ctypes.c_void_p, ctypes.c_int
        argtypes = {
            # raw rows q, hi lo sabs; n d b t; stream
            "dd_rows": ("omni_dd_rows", [p] * 6 + [i] * 4 + [p]),
            # emb1 emb2 bloom scale1 scale2 err2 valid, q kw_w8 kw_b, rows vals rec,
            # out; n d w b m; stream
            "refine": ("omni_refine", [p] * 14 + [i] * 5 + [p]),
        }
        for name, proc in self.procs.items():
            log, _ = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on the parent's {name}.cu:\n{log}")
            lib = ctypes.CDLL(str(self.paths[name]))
            fn = getattr(lib, argtypes[name][0])
            fn.restype, fn.argtypes = ctypes.c_int, argtypes[name][1]
            self.libs[name] = fn

    def dd_rows(self, raw, rows, q):
        """The parent's K2: (hi, lo, sabs) [B, t]."""
        import torch

        from omni_recall_tpu_torch.ops import cuda

        (n, d), (b, t) = raw.shape, rows.shape
        hi, lo, sabs = (torch.empty((b, t), dtype=torch.float32, device=raw.device)
                        for _ in range(3))
        rc = self.libs["dd_rows"](raw.data_ptr(), rows.data_ptr(), q.data_ptr(), hi.data_ptr(),
                                  lo.data_ptr(), sabs.data_ptr(), n, d, b, t,
                                  cuda.stream_ptr(raw.device))
        if rc:
            raise RuntimeError(f"the parent's K2 failed to launch ({rc})")
        return hi, lo, sabs

    def refine(self, emb1, scale1, emb2, scale2, err2, bloom, valid, q, kw_w8, kw_b, rows,
               vals, rec):
        """The parent's K3 kernel, given the recency term ``rec`` [B, m]."""
        import torch

        from omni_recall_tpu_torch.ops import cuda

        (n, d), (b, m), w = emb1.shape, rows.shape, bloom.shape[1]
        out = torch.empty((b, m), dtype=torch.float32, device=emb1.device)
        ptrs = [x.data_ptr() for x in (emb1, emb2, bloom, scale1, scale2, err2, valid, q, kw_w8,
                                       kw_b, rows.contiguous(), vals.contiguous(), rec, out)]
        rc = self.libs["refine"](*ptrs, n, d, w, b, m, cuda.stream_ptr(emb1.device))
        if rc:
            raise RuntimeError(f"the parent's K3 failed to launch ({rc})")
        return out


def timed_ab(kern, parent=None, same=None) -> tuple[float, dict]:
    """The kernel's device time; given ``parent`` (the parent's build of the
    same function), the same-call A/B around it (parent, kernel, kernel,
    parent) and whether ``same`` holds the parent's output to the kernel's."""
    import torch

    if parent is None:
        return time_ms(kern, device_only=True), {}
    got, want = parent(), kern()
    torch.cuda.synchronize()
    ab = {"parent_bitwise": same(got, want), "parent_ms": time_ms(parent, device_only=True)}
    ms = time_ms(kern, device_only=True)
    ab["ms_after"] = time_ms(kern, device_only=True)
    ab["parent_ms_after"] = time_ms(parent, device_only=True)
    return ms, ab


# rows that fit in the 50 MB L2 (for l2_rows_ms)
L2_ROWS_BYTES = 24 << 20


def gather_diagnostics(kern_l2, planes, rows) -> dict:
    """What holds a gather kernel (K2, K3) back: ``l2_rows_ms``, the kernel
    on the same queries with its rows drawn from the first L2_ROWS_BYTES of
    the planes (resident in L2 after the first run), and ``gather_ms``,
    PyTorch's gather of the same rows of each plane (``index_select``: each
    row read once and written once) as a yardstick of the card's rate for
    this access pattern."""
    flat = rows.clamp_min(0).flatten().long()
    return {"l2_rows_ms": time_ms(kern_l2, device_only=True),
            "gather_ms": time_ms(lambda: [x.index_select(0, flat) for x in planes],
                                 device_only=True)}


# what a kernel line carries of the same-call A/B with the parent's build
PARENT_KEYS = ("parent_ms", "parent_ms_after", "ms_after", "parent_bitwise")


def pair_bitwise(a, b) -> bool:
    return bitwise(a[0], b[0]) and bitwise(a[1], b[1])


def dd_same(a, b) -> bool:
    """K2's parity: hi and lo bitwise, sabs (summed in any order) within
    SABS_REL."""
    from omni_recall_tpu_torch.ops import exact_cos

    rel = float(((a[2] - b[2]).abs() / b[2].abs().clamp_min(1e-30)).max())
    return bitwise(a[0], b[0]) and bitwise(a[1], b[1]) and rel <= exact_cos.SABS_REL


def kernel_phase(seed: int, parent=None) -> dict:
    """Each kernel against its plain version at the serving shapes;
    ``parent`` (``ParentBuild``) times the parent's K2 and K3 beside them."""
    import torch

    from omni_recall_tpu_torch.ops import exact_cos, scorer

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)

    def ri(lo, hi, shape, dtype):
        return torch.randint(lo, hi, shape, generator=g, device=dev).to(dtype)

    def rf(shape, scale=1.0, offset=0.0):
        return torch.rand(shape, generator=g, device=dev) * scale + offset

    n, d, b, w = N_ROWS, DIM, BATCH, BITS // 8
    emb8 = ri(-127, 128, (n, d), torch.int8)
    q8 = ri(-127, 128, (b, d), torch.int8)
    bloom = ri(0, 256, (n, w), torch.uint8)
    kw_w8 = torch.where(rf((b, 8 * w)) < 0.03, ri(1, 128, (b, 8 * w), torch.int8),
                        torch.zeros((), dtype=torch.int8, device=dev))
    kw_b = rf((b, 1), 0.05)
    add_row = rf((1, n), 0.1)
    add_row[0, rf((n,)) < 0.01] = -1e30  # tombstones
    scale_row = rf((1, n), 1e-3, 1e-3)
    q_scale = rf((b, 1), 1e-3, 1e-3)
    q_bias = rf((b, 1), 0.01)
    results = {}

    def scan_line(name, replaces, kern, plain, bytes_moved, ops, library=(None, None)):
        kv, ki = kern()
        pv, pi = plain()
        torch.cuda.synchronize()
        ok = bitwise(kv, pv) and bitwise(ki, pi)
        err = float((kv - pv).abs().max())
        ms = time_ms(kern, device_only=True)
        plain_ms = time_ms(plain)
        bms, by = bound_ms(bytes_moved, ops, INT8_OPS_PER_S)
        line = dict(name=name, replaces=replaces, shape=list(kv.shape),
                    parity=bitwise_parity(ok), max_abs_err=err, ms=ms, plain_ms=plain_ms,
                    bound_ms=bms, bound_by=by, library_ms=library[0], library=library[1])
        emit({"phase": "kernel", **line})
        if not ok:
            raise AssertionError(f"{name}: kernel disagrees with its plain version")
        return line

    out_bytes = lambda t1, sub: b * (n // sub) * t1 * 8  # noqa: E731
    int_mm = int_mm_yardstick(q8, emb8)
    # K1 in the serving layout (sub 1024, t 2 -> packed keys), and its
    # two-reduce mode (t 1 -> t1 = 2) at the same shapes
    for mode, sub, t, replaces in (("packed", 1024, 2, 628), ("two_reduce", 1024, 1, 679)):
        t1 = t + 1
        results[f"coarse_{mode}"] = scan_line(
            f"coarse_scan[{mode}]",
            f"omni_recall_tpu/ops/pallas_scorer.py:{replaces}",
            lambda: scorer.block_topt_int8_coarse(
                emb8, q8, add_row, scale_row, q_scale, q_bias, t=t, sub=sub),
            lambda: scorer.block_topt_int8_coarse_plain(
                emb8, q8, add_row, scale_row, q_scale, q_bias, t=t, sub=sub),
            n * d + b * d + 8 * n + 8 * b + out_bytes(t1, sub),
            2.0 * n * d * b, int_mm,
        )
    # K4 at the rescue layout (_select_scorer: sub 512, t 4)
    results["fused"] = scan_line(
        "fused_scan", "omni_recall_tpu/ops/pallas_scorer.py:824",
        lambda: scorer.block_topt_int8(
            emb8, bloom, q8, kw_w8, kw_b, add_row, scale_row, q_scale, q_bias, t=4, sub=512),
        lambda: scorer.block_topt_int8_plain(
            emb8, bloom, q8, kw_w8, kw_b, add_row, scale_row, q_scale, q_bias, t=4, sub=512),
        n * d + n * w + b * d + b * 8 * w + 8 * n + 12 * b + out_bytes(5, 512),
        2.0 * n * b * (d + 8 * w), int_mm,
    )
    # K5 at the keyword-scan layout (_coarse_layout: sub 1024, t 4)
    results["kw"] = scan_line(
        "kw_scan", "omni_recall_tpu/ops/pallas_scorer.py:519",
        lambda: scorer.block_topt_kw_only(bloom, kw_w8, kw_b, add_row, t=4, sub=1024),
        lambda: scorer.block_topt_kw_only_plain(bloom, kw_w8, kw_b, add_row, t=4, sub=1024),
        n * w + b * 8 * w + 4 * n + 4 * b + out_bytes(5, 1024),
        2.0 * n * b * 8 * w, kw_mm_yardstick(kw_w8, bloom),
    )
    results["kw"]["query_tile"] = scorer.int8_kw_query_tile(1024, w)
    results["kw"]["sub512"] = kw_sub512_line(bloom, kw_w8, kw_b, add_row)
    results.update(refine_lines(g, emb8, bloom, kw_w8, kw_b[:, 0], scale_row[0], seed, parent))
    results["t5"] = t5_lines(g, emb8, bloom, q8, add_row)
    results["t2"] = t2_lines(emb8, q8, add_row, scale_row, q_scale, q_bias)
    del emb8
    torch.cuda.empty_cache()
    results["t4"] = t4_lines(dev, seed)
    torch.cuda.empty_cache()
    results.update(fp_scan_lines(g, bloom, kw_b, add_row))
    del bloom
    torch.cuda.empty_cache()

    # K2 at the serving selection width (t_out = 32) over the raw f32 plane
    raw = torch.randn((n, d), generator=g, device=dev) / d ** 0.5
    q_raw = torch.randn((b, d), generator=g, device=dev) / d ** 0.5
    rows = ri(-1, n, (b, DD_T), torch.int32)
    kern = lambda: exact_cos.exact_cos_rows(raw, rows, q_raw)  # noqa: E731
    plain = lambda: exact_cos.exact_cos_rows_plain(raw, rows, q_raw)  # noqa: E731
    kh, kl, ks = kern()
    ph, pl, ps = plain()
    torch.cuda.synchronize()
    sabs_rel = float(((ks - ps).abs() / ps.abs().clamp_min(1e-30)).max())
    ok = dd_same((kh, kl, ks), (ph, pl, ps))
    err = max(float((kh - ph).abs().max()), float((kl - pl).abs().max()),
              float((ks - ps).abs().max()))
    p2 = 1 << (d - 1).bit_length()
    pairs = b * DD_T
    bms, by = bound_ms(
        pairs * d * 4 + b * d * 4 + pairs * 4 + 3 * pairs * 4,
        pairs * (2 * d + 14 * (p2 - 1)), F32_OPS_PER_S,
    )
    ms, ab = timed_ab(kern, parent and (lambda: parent.dd_rows(raw, rows, q_raw)), dd_same)
    l2_rows = ri(0, L2_ROWS_BYTES // (4 * d), (b, DD_T), torch.int32)
    line = dict(name="dd_rows", replaces="omni_recall_tpu/ops/exact_cos.py:171",
                shape=[b, DD_T, d], layout=exact_cos.dd_rows_layout(d),
                parity=bitwise_parity(ok), sabs_rel_err=sabs_rel,
                max_abs_err=err, ms=ms, plain_ms=time_ms(plain),
                bound_ms=bms, bound_by=by, library_ms=None, **ab,
                **gather_diagnostics(lambda: exact_cos.exact_cos_rows(raw, l2_rows, q_raw),
                                     (raw,), rows))
    emit({"phase": "kernel", **line})
    if not ok:
        raise AssertionError("dd_rows: kernel disagrees with its plain version")
    if not ab.get("parent_bitwise", True):
        raise AssertionError("dd_rows: kernel disagrees with the parent's build")
    results["dd"] = line
    results["dd_gathered"] = dd_gathered_line(raw, rows, q_raw, (kh, kl, ks))
    del raw, q_raw
    torch.cuda.empty_cache()
    return results


def dd_gathered_line(raw, rows, q_raw, by_index) -> dict:
    """K2's second entry, ``exact_cos.dd_rows(q_raw, c)`` over rows already
    gathered (the row-sharded path's owner gather), on the K2 line's rows:
    hi and lo bitwise its plain version (sabs within SABS_REL), and all
    three outputs bitwise the by-index entry's."""
    import torch

    from omni_recall_tpu_torch.ops import exact_cos

    b, t = rows.shape
    d = raw.shape[1]
    c = raw.index_select(0, torch.where(rows < 0, 0, rows).reshape(-1).long()).reshape(b, t, d)
    kern = lambda: exact_cos.dd_rows(q_raw, c)  # noqa: E731
    plain = lambda: exact_cos.dd_sum_products(q_raw[:, None, :], c)  # noqa: E731
    got, want = kern(), plain()
    torch.cuda.synchronize()
    ok = dd_same(got, want)
    same_as_index = all(bitwise(x, y) for x, y in zip(got, by_index))
    p2 = 1 << (d - 1).bit_length()
    pairs = b * t
    bms, by = bound_ms(pairs * d * 4 + b * d * 4 + 3 * pairs * 4,
                       pairs * (2 * d + 14 * (p2 - 1)), F32_OPS_PER_S)
    line = dict(name="dd_rows[gathered]", replaces="omni_recall_tpu/ops/exact_cos.py:171",
                entry="omni_dd_rows_gathered", shape=[b, t, d], parity=bitwise_parity(ok),
                by_index_bitwise=same_as_index,
                sabs_rel_err=float(((got[2] - want[2]).abs()
                                    / want[2].abs().clamp_min(1e-30)).max()),
                max_abs_err=max(float((x - y).abs().max()) for x, y in zip(got, want)),
                ms=time_ms(kern, device_only=True), plain_ms=time_ms(plain),
                bound_ms=bms, bound_by=by, library_ms=None)
    emit({"phase": "kernel", **line})
    if not ok:
        raise AssertionError("dd_rows[gathered]: kernel disagrees with its plain version")
    if not same_as_index:
        raise AssertionError("dd_rows[gathered]: disagrees with the by-index entry")
    return line


REFINE_SHAPES = {"select": (BATCH, 64), "rescue": (64, 2048)}


def refine_lines(g, emb1, bloom, kw_w8, kw_b, scale1, seed: int, parent=None) -> dict:
    """K3 at the select stage's [448, 64] and the rescue stage's [64, 2048]
    candidate shapes over the 2^20-row planes: bitwise against its plain
    version, also given rows and scan bounds as column slices of a wider
    [B, m + 1] tensor (as the engine passes them); card ms (the kernel),
    wrapper ms (``_refine_dispatch``, as the engine calls it) and plain ms.
    Given ``parent`` (``ParentBuild``), the parent's kernel on the same
    operands (with the recency term it took from outside), timed around it
    and held bitwise. ``gather_diagnostics`` as in K2's line. Then K3's
    recency term and its exp alone against PyTorch's (recency_lines), and T3
    over the same planes (t3_lines)."""
    import torch

    from omni_recall_tpu_torch.ops import refine

    dev = emb1.device
    n, d = emb1.shape
    w = bloom.shape[1]
    emb2 = torch.randint(-127, 128, (n, d), generator=g, device=dev).to(torch.int8)
    scale2 = torch.rand((n,), generator=g, device=dev) * 1e-4
    err2 = torch.rand((n,), generator=g, device=dev) * 4e-5
    created = torch.rand((n,), generator=g, device=dev) * 400.0
    valid = torch.rand((n,), generator=g, device=dev) > 0.01
    gd = torch.Generator(device=dev).manual_seed(seed + 5)  # the diagnostics' own draws
    out = {}
    for stage, (b, m) in REFINE_SHAPES.items():
        q = torch.randn((b, d), generator=g, device=dev)
        q /= q.norm(dim=1, keepdim=True)
        rows = torch.randint(-1, n, (b, m), generator=g, device=dev).to(torch.int32)
        vals = torch.randn((b, m), generator=g, device=dev)
        vals[torch.rand((b, m), generator=g, device=dev) < 0.01] = float("-inf")
        planes = (emb1, scale1, emb2, scale2, err2, bloom)
        args = (*planes, created, valid, q, kw_w8[:b], kw_b[:b], 365.0, rows, vals)
        kern = lambda: refine.refine_bounds_cuda(*args)  # noqa: E731, B023
        plain = lambda: refine.refine_bounds_plain(*args)  # noqa: E731, B023
        wrapper = lambda: refine._refine_dispatch(*args)  # noqa: E731, B023
        wide_rows = torch.cat([rows, rows[:, :1]], dim=1)
        wide_vals = torch.cat([vals, vals[:, :1]], dim=1)
        got, want, via = kern(), plain(), wrapper()
        strided = refine.refine_bounds_cuda(*args[:-2], wide_rows[:, :m], wide_vals[:, :m])
        torch.cuda.synchronize()
        ok = bitwise(got, want) and bitwise(via, want) and bitwise(strided, want)
        fin = torch.isfinite(want)
        err = float((got[fin] - want[fin]).abs().max())
        rec = refine.recency_term(created, 365.0, rows)
        ms, ab = timed_ab(kern, parent and (lambda: parent.refine(  # noqa: B023
            *planes, valid, q, kw_w8[:b], kw_b[:b], rows, vals, rec)), bitwise)  # noqa: B023
        # bytes: each distinct candidate row's two int8 rows, bloom row and
        # four f32 sidecars (with created) once; per slot its row id, scan
        # bound and output; per query its f32 row, keyword weights and bias
        uniq = int(torch.unique(rows.clamp_min(0)).numel())
        slots = b * m
        bms, by = bound_ms(uniq * (2 * d + w + 17) + slots * 12 + b * (4 * d + 8 * w + 4),
                           slots * (8.0 * d + 16.0 * w), INT8_OPS_PER_S)
        l2_rows = torch.randint(0, L2_ROWS_BYTES // (2 * d + w), (b, m), generator=gd,
                                device=dev).to(torch.int32)
        line = dict(name=f"refine[{stage}]", replaces="omni_recall_tpu/ops/refine.py:467",
                    shape=[b, m, d], parity=bitwise_parity(ok), strided_bitwise=bitwise(
                        strided, want), max_abs_err=err, unique_rows=uniq,
                    neg_inf=int((~fin).sum()), ms=ms, wrapper_ms=time_ms(wrapper),
                    plain_ms=time_ms(plain), bound_ms=bms, bound_by=by, library_ms=None, **ab,
                    **gather_diagnostics(lambda: refine.refine_bounds_cuda(  # noqa: B023
                        *args[:-2], l2_rows, vals), (emb1, emb2, bloom), rows))  # noqa: B023
        emit({"phase": "kernel", **line})
        if not ok:
            raise AssertionError(f"refine[{stage}]: kernel disagrees with its plain version")
        if not ab.get("parent_bitwise", True):
            raise AssertionError(f"refine[{stage}]: kernel disagrees with the parent's build")
        out[f"refine_{stage}"] = line
    out["refine_recency"] = recency_lines(created)
    out["refine_t3"] = t3_lines(seed, emb1, scale1, emb2, scale2, err2, bloom, created, valid)
    del emb2
    torch.cuda.empty_cache()
    return out


def recency_lines(created) -> dict:
    """K3 computes the recency term inside, with the CUDA math library's
    expf, on the condition that it gives torch.exp's bits on the term's
    whole domain. Its exp alone (``refine.kernel_recency`` with no day)
    against ``torch.exp`` on every f32 argument <= 0 (+0, and -0 down to
    -inf: 2^31 - 2^23 + 2 values, in chunks of 2^28); then the term itself
    against ``refine.recency_term`` over every row of the kernel phase's
    index (created days uniform in [0, 400), now = 365), of the serve
    phase's corpus (``corpus_created_days``, now = 365) and of an index
    dated as serving dates it (now = this run's day since EPOCH, created
    uniform over the ten years before it and the month after). Any
    differing value fails the run."""
    import torch

    from omni_recall_tpu_torch.index.device_index import EPOCH
    from omni_recall_tpu_torch.ops import refine

    dev = created.device
    n = created.shape[0]

    def mismatches(got, want) -> int:
        return int((got.view(torch.int32) != want.view(torch.int32)).sum())

    neg_zero, neg_inf, chunk = -(1 << 31), -(1 << 23), 1 << 28  # int32 bits of -0 and -inf
    bad = mismatches(refine.kernel_recency(torch.zeros(1, device=dev)),
                     torch.exp(torch.zeros(1, device=dev)))
    for start in range(neg_zero, neg_inf + 1, chunk):
        x = torch.arange(start, min(start + chunk, neg_inf + 1), dtype=torch.int32,
                         device=dev).view(torch.float32)
        bad += mismatches(refine.kernel_recency(x), torch.exp(x))
        del x
    line = {"name": "refine_recency", "rows": n, "exp_arguments": neg_inf - neg_zero + 2,
            "exp_mismatches": bad}
    today = (datetime.datetime.now(datetime.timezone.utc) - EPOCH).total_seconds() / 86400.0
    g = torch.Generator(device=dev).manual_seed(7)
    dated = torch.rand((n,), generator=g, device=dev) * 3680.0 + (today - 3650.0)
    rows = torch.arange(n, dtype=torch.int32, device=dev)
    for name, days, now in (
            ("kernel_index", created, 365.0),
            ("serve_corpus", torch.from_numpy(corpus_created_days(n)).to(dev), 365.0),
            ("dated_index", dated, today)):
        line[f"{name}_mismatches"] = mismatches(refine.kernel_recency(days, now),
                                                refine.recency_term(days, now, rows))
    line["dated_now"] = today
    emit({"phase": "kernel", **line})
    if any(v for k, v in line.items() if k.endswith("mismatches")):
        raise AssertionError(f"refine_recency: K3's expf differs from torch.exp ({line})")
    return line


T3_SHAPES = {"tool": (1536, 128), "select": (BATCH, 64)}  # (B, m)


def t3_lines(seed: int, emb1, scale1, emb2, scale2, err2, bloom, created, valid) -> dict:
    """T3 at the tool's shape and at K3's select shape over the 2^20-row
    planes, on K3's candidates (sentinel slots, invalid rows, -inf scan
    bounds) gathered as the JAX K3 wrapper gathers them: bitwise against its
    plain version, and its block diagonal bitwise against K3's kernel on the
    same candidates. Card ms beside the bound; beside them at the same shape
    K3's kernel and its wrapper, and the two stages
    the TPU's design adds before T3: the tool's four gathers (G) and the
    query quantization (Q). Inputs from a generator of their own, so the
    other lines' inputs stay as they were."""
    import torch

    from omni_recall_tpu_torch.ops import refine
    from omni_recall_tpu_torch.tools import probe_serve as t3

    dev = emb1.device
    g = torch.Generator(device=dev).manual_seed(seed + 3)
    (n, d), w = emb1.shape, bloom.shape[1]
    sidecar = t3.stack_sidecar(scale1, scale2, err2, created, valid)
    out = {}
    for shape, (b, m) in T3_SHAPES.items():
        q = torch.randn((b, d), generator=g, device=dev)
        q /= q.norm(dim=1, keepdim=True)
        kw = torch.where(torch.rand((b, 8 * w), generator=g, device=dev) < 0.03,
                         torch.rand((b, 8 * w), generator=g, device=dev) * 0.1,
                         torch.zeros((), device=dev))
        kw_w8 = refine.quantize_kw_weights(kw)
        kw_b = torch.rand((b,), generator=g, device=dev) * 0.05
        rows = torch.randint(-1, n, (b, m), generator=g, device=dev).to(torch.int32)
        vals = torch.randn((b, m), generator=g, device=dev)
        vals[torch.rand((b, m), generator=g, device=dev) < 0.01] = float("-inf")
        args = (emb1, scale1, emb2, scale2, err2, bloom, created, valid, q, kw_w8, kw_b,
                365.0, rows, vals)
        ops, qg = t3.k3_slab_operands(*args)
        kern = lambda: refine.refine_slab_tile(*ops, qg)  # noqa: E731, B023
        plain = lambda: refine.refine_slab_tile_plain(*ops, qg)  # noqa: E731, B023
        k3 = lambda: refine.refine_bounds_cuda(*args)  # noqa: E731, B023
        got, want, k3_out = kern(), plain(), k3()
        torch.cuda.synchronize()
        ok = bitwise(got, want)
        diag_ok = bitwise(t3.block_diagonal(got, m, qg), k3_out)
        safe = rows.clamp_min(0)
        bms, by = bound_ms(*t3.slab_work(b, m, d, w, qg), INT8_OPS_PER_S)
        line = dict(name=f"probe_serve[{shape}]", replaces="tools/probe_serve.py:210",
                    shape=[b, m, d], qg=qg, ct=qg * m, out_shape=list(got.shape),
                    parity=bitwise_parity(ok),
                    k3_diagonal_bitwise=diag_ok, max_abs_err=float((got - want).abs().max()),
                    ms=time_ms(kern, device_only=True), plain_ms=time_ms(plain), plain_runs=5,
                    bound_ms=bms, bound_by=by, library_ms=None,
                    k3_ms=time_ms(k3, device_only=True),
                    k3_wrapper_ms=time_ms(lambda: refine._refine_dispatch(*args)),  # noqa: B023
                    gather_ms=time_ms(lambda: t3.gather_slabs(  # noqa: B023
                        emb1, emb2, bloom, sidecar, safe), device_only=True),  # noqa: B023
                    quantize_ms=time_ms(lambda: refine.quantize_queries_int8_residual(q),  # noqa: B023
                                        device_only=True))
        line["gather_quantize_t3_ms"] = line["gather_ms"] + line["quantize_ms"] + line["ms"]
        emit({"phase": "kernel", **line})
        if not ok:
            raise AssertionError(f"probe_serve[{shape}]: kernel disagrees with its plain version")
        if not diag_ok:
            raise AssertionError(f"probe_serve[{shape}]: block diagonal disagrees with K3")
        out[shape] = line
        del ops, got, want, k3_out
        torch.cuda.empty_cache()
    return out


def plain_once(plain):
    """A plain version that takes seconds at these shapes: its one
    comparison call, timed by the host clock."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = plain()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


FP_T, FP_SUB = 4, 512  # K6's layout at m = 128 over 2^20 rows (_select_scorer)
FP_SOUND_QUERIES = 8   # queries whose every slice is checked against a float64 scan
FP_CLEAR_SHARE = 0.75  # the parity rule: slices clear of the bound, at least
# The random keyword weights of the K6 lines: FP_KW_SHARE of the bits, in
# [0, FP_KW_MAX). The clear share is a property of the plain values alone,
# and at the default --seed it is 75.43% (an H100, PERF.md §7): the
# gate above rests on these two, on the seed and on the order in which
# kernel_phase draws from its generator. Change any of them only with a
# card run that reads clear_share again.
FP_KW_SHARE, FP_KW_MAX = 0.03, 0.1
# what a K6 / T1 kernel line reports of the parity rule
FP_RULE_KEYS = ("query_tile", "exact_inputs_bitwise", "order_bound", "within_bound",
                "clear_share", "indices_equal_where_clear", "sound")


def fp_rule(kv, pv, q, rows, kw, granule=0, ki=None, pi=None, cos_weight=0.7) -> dict:
    """The parity rule's part (ii) (ops/scorer.py fp_order_bound and
    fp_order_check): the largest bound over live entries beside the check's
    results."""
    from omni_recall_tpu_torch.ops import scorer

    bound = scorer.fp_order_bound(pv, scorer.fp_cos_mass(q, rows), kw, d=q.shape[1],
                                  cos_weight=cos_weight, granule=granule)
    got = scorer.fp_order_check(kv, pv, bound, ki, pi)
    got["order_bound"] = float(bound[pv > -1e29].max())
    return got


def fp_sound(vals, idxs, emb, bloom, q, kw, kw_b, add_row, sub: int) -> bool:
    """The parity rule's part (iii) for the first FP_SOUND_QUERIES queries:
    every emitted value, and every slice bound, is at least the float64
    hybrid score (0.7 cos + 0.2 min(1, kw + bias) + add_row, from the
    unrounded operands) of each live row it stands for."""
    import torch

    from omni_recall_tpu_torch.ops import xla_scorer

    nq = FP_SOUND_QUERIES
    bits = xla_scorer.unpack_bloom_bits(bloom).double()
    exact = (0.7 * (q[:nq].double() @ emb.double().T)
             + 0.2 * torch.clamp_max(kw[:nq].double() @ bits.T + kw_b[:nq].double(), 1.0)
             + add_row.double())
    del bits
    live = add_row.reshape(-1) > -1e29
    exact = torch.where(live[None, :], exact, torch.full_like(exact, float("-inf")))
    v, i = vals[:nq].double(), idxs[:nq].long()
    t = v.shape[-1] - 1
    cand_ok = bool((v[..., :t] >= exact.gather(1, i[..., :t].reshape(nq, -1)).reshape(
        nq, -1, t)).all())
    rest = exact.scatter(1, i[..., :t].reshape(nq, -1), float("-inf"))
    bound_ok = bool((v[..., t] >= rest.reshape(nq, -1, sub).amax(dim=-1)).all())
    return cand_ok and bound_ok


def fp_scan_lines(g, bloom, kw_b, add_row) -> dict:
    """K6 on bf16 and on f32 rows at the serving shapes under the parity
    rule (its plain version takes seconds at this size: timed once a call):
    (i) bitwise on exactly-summable inputs, (ii) within the order bound on
    unit rows and queries, indices equal in every clear slice and over
    FP_CLEAR_SHARE of the slices clear, (iii) sound against a float64 scan
    of sampled queries. Then the xla scorer's score_topm on the f32 rows at
    m = 128."""
    import torch

    from omni_recall_tpu_torch.ops import scorer, xla_scorer

    dev = bloom.device
    n, w = bloom.shape
    d, b = DIM, BATCH
    emb = torch.randn((n, d), generator=g, device=dev)
    emb /= emb.norm(dim=1, keepdim=True)
    q = torch.randn((b, d), generator=g, device=dev)
    q /= q.norm(dim=1, keepdim=True)
    kw = torch.where(torch.rand((b, 8 * w), generator=g, device=dev) < FP_KW_SHARE,
                     torch.rand((b, 8 * w), generator=g, device=dev) * FP_KW_MAX,
                     torch.zeros((), device=dev))
    ex_emb, ex_q, ex_kw = scorer.fp_exact_operands(g, n, d, b, w)
    t1 = FP_T + 1
    granule = FP_SUB if scorer._packed_mode(FP_SUB, t1) else 0
    out = {}
    for storage, dtype in (("bf16", torch.bfloat16), ("f32", torch.float32)):
        ex_args = (ex_emb.to(dtype), bloom, ex_q, ex_kw, kw_b, add_row)
        kv, ki = scorer.block_topt(*ex_args, t=FP_T, sub=FP_SUB)
        pv, pi = scorer.block_topt_plain(*ex_args, t=FP_T, sub=FP_SUB)
        exact_ok = bitwise(kv, pv) and bitwise(ki, pi)
        del ex_args, kv, ki, pv, pi
        rows = emb.to(dtype)
        args = (rows, bloom, q, kw, kw_b, add_row)
        kern = lambda: scorer.block_topt(*args, t=FP_T, sub=FP_SUB)  # noqa: E731
        plain = lambda: scorer.block_topt_plain(*args, t=FP_T, sub=FP_SUB)  # noqa: E731
        kv, ki = kern()
        (pv, pi), plain_ms = plain_once(plain)
        rule = fp_rule(kv, pv, q, rows, kw, granule, ki, pi)
        sound = fp_sound(kv, ki, emb, bloom, q, kw, kw_b, add_row, FP_SUB)
        ok = (exact_ok and rule["within"] and rule["indices_equal_where_clear"]
              and rule["clear_share"] > FP_CLEAR_SHARE and sound)
        bms, by = bound_ms(
            n * d * rows.element_size() + n * w + b * d * 4 + b * 8 * w * 4 + 4 * b + 4 * n
            + b * (n // FP_SUB) * t1 * 8,
            2.0 * n * b * (d + 8 * w), BF16_OPS_PER_S)
        line = dict(name=f"fp_scan[{storage}]",
                    replaces="omni_recall_tpu/ops/pallas_scorer.py:737", storage=storage,
                    shape=[b, n, d], layout=[FP_SUB, FP_T],
                    query_tile=scorer.fp_query_tile(0, FP_SUB, d, w),
                    parity="order rule" if ok else "FAILED", exact_inputs_bitwise=exact_ok,
                    max_abs_err=rule["max_abs_err"], order_bound=rule["order_bound"],
                    within_bound=rule["within"], clear_share=rule["clear_share"],
                    indices_equal_where_clear=rule["indices_equal_where_clear"],
                    sound=sound, sound_queries=FP_SOUND_QUERIES,
                    ms=time_ms(kern, device_only=True), plain_ms=plain_ms,
                    plain_runs=1, bound_ms=bms, bound_by=by, library_ms=None)
        emit({"phase": "kernel", **line})
        if not ok:
            raise AssertionError(f"fp_scan[{storage}] breaks the parity rule: {line}")
        out[f"fp_{storage}"] = line
        del rows, args, kv, ki, pv, pi
        torch.cuda.empty_cache()
    out["t1"] = t1_lines(emb.to(torch.bfloat16), bloom, q, kw, kw_b, add_row,
                         (ex_emb.to(torch.bfloat16), ex_q, ex_kw))
    del ex_emb, ex_q, ex_kw
    torch.cuda.empty_cache()

    # the xla scorer (plain torch: cuBLAS f32 products with TF32 refused,
    # torch.topk) at the same shape, m = 128
    created = torch.rand((n,), generator=g, device=dev) * 365.0
    valid = torch.rand((n,), generator=g, device=dev) > 0.01
    m = 128
    twin = lambda: xla_scorer.score_topm(  # noqa: E731
        emb, bloom, created, valid, q, kw, kw_b[:, 0], 365.0, 0, m=m)
    tv, ti = twin()
    # a float64 scan of a few queries: the twin's values within its bound
    nq = 4
    bits = xla_scorer.unpack_bloom_bits(bloom).double()
    exact = (0.7 * (q[:nq].double() @ emb.double().T)
             + 0.2 * torch.clamp_max(kw[:nq].double() @ bits.T + kw_b[:nq].double(), 1.0)
             + 0.1 * torch.exp(torch.clamp_max(created.double() - 365.0, 0.0) / 30.0)
             + xla_scorer.CERT_EPS)
    exact = torch.where(valid[None, :], exact, torch.full_like(exact, float("-inf")))
    ev = torch.topk(exact, m + 1, dim=1).values
    err = float((tv[:nq].double() - ev).abs().max())
    rows_ok = bool((exact.gather(1, ti[:nq].long()) > float("-inf")).all())
    del bits, exact
    torch.cuda.empty_cache()
    ops = 2.0 * n * b * (d + 8 * w)
    line = dict(name="xla_scorer.score_topm", replaces="omni_recall_tpu/ops/xla_scorer.py:120",
                shape=[b, n, d], m=m, out_shape=list(tv.shape), ms=time_ms(twin, device_only=True),
                f32_floor_ms=ops / F32_OPS_PER_S * 1e3, floor_by="operations (f32, CUDA cores)",
                max_abs_err_vs_f64=err, tf32_guard="xla_scorer.check_tf32_off: raises unless "
                "allow_tf32 is False and the float32 matmul precision is 'highest'")
    emit({"phase": "kernel", **line})
    if list(tv.shape) != [b, m + 1] or not rows_ok or not err <= 1e-4:
        raise AssertionError(f"xla scorer: {line}")
    out["xla"] = line
    return out


T1_C = 1024  # T1's block in its kernel lines: the tool's first, 32 queries a tile


def t1_bound(variant: str, n: int, b: int, d: int, w: int, c: int) -> tuple[float, str]:
    """T1's least time: rows (bf16) and queries read once, bloom, keyword
    weights and per-row terms too unless cosine only, its output written
    once; 2 operations a bf16 product term."""
    terms = d if variant == "cos" else d + 8 * w
    read = n * d * 2 + b * d * 4
    if variant != "cos":
        read += n * w + b * 8 * w * 4 + 4 * b + 4 * n
    out = (n // c) * b * (9 if variant == "full" else 128) * 4
    return bound_ms(read + out, 2.0 * n * b * terms, BF16_OPS_PER_S)


def t5_bound(n: int, b: int, d: int, w: int) -> tuple[float, str]:
    """T5's least time: int8 rows, bloom, queries and keyword weights and the
    f32 recency row read once, the slice maxima written once; 2 int8
    operations a product term."""
    return bound_ms(n * d + n * w + b * d + b * 8 * w + 4 * n + b * (n // 512) * 4,
                    2.0 * n * b * (d + 8 * w), INT8_OPS_PER_S)


def t1_lines(rows, bloom, q, kw, kw_b, add_row, exact) -> dict:
    """T1's three variants over the bf16 rows at the serving shapes, blocks
    of 1024, under K6's parity rule: bitwise on the exactly-summable inputs
    ``exact`` (rows, queries, keyword weights), within the order bound on
    the unit rows (T1-cos: the cosine itself, no keyword term); cosine only
    beside one bf16 matmul (cuBLAS, TF32 off), which writes all N columns."""
    import torch

    from omni_recall_tpu_torch.ops import scorer
    from omni_recall_tpu_torch.tools import profile_kernel as t1

    (n, d), b, w = rows.shape, q.shape[0], bloom.shape[1]
    args = (rows, bloom, q, kw, kw_b, add_row)
    ex_args = (exact[0], bloom, exact[1], exact[2], kw_b, add_row)
    body_line = {"cos": 53, "coskw": 60, "full": 72}
    out = {}
    for variant in t1.VARIANTS:
        ex_ok = bitwise(t1.profile_scan(variant, *ex_args, T1_C),
                        t1.profile_scan_plain(variant, *ex_args, T1_C))
        kern = lambda: t1.profile_scan(variant, *args, T1_C)  # noqa: E731, B023
        got = kern()
        want, plain_ms = plain_once(lambda: t1.profile_scan_plain(variant, *args, T1_C))  # noqa: B023
        cos_only = variant == "cos"
        rule = fp_rule(got.transpose(0, 1), want.transpose(0, 1), q, rows,
                       None if cos_only else kw, cos_weight=1.0 if cos_only else 0.7)
        ok = ex_ok and rule["within"]
        library_ms = None
        if cos_only:
            qb = q.to(torch.bfloat16)
            with scorer._no_tf32():
                library_ms = time_ms(lambda: torch.matmul(qb, rows.t()), device_only=True)
        bms, by = t1_bound(variant, n, b, d, w, T1_C)
        line = dict(name=f"profile_kernel[{variant}]",
                    replaces=f"tools/profile_kernel.py:{body_line[variant]}",
                    shape=[b, n, d], c=T1_C, query_tile=t1.query_tile(T1_C, variant),
                    out_shape=list(got.shape), parity="order rule" if ok else "FAILED",
                    exact_inputs_bitwise=ex_ok, max_abs_err=rule["max_abs_err"],
                    order_bound=rule["order_bound"], within_bound=rule["within"],
                    clear_share=None, indices_equal_where_clear=None, sound=None,
                    ms=time_ms(kern, device_only=True), plain_ms=plain_ms, plain_runs=1,
                    bound_ms=bms, bound_by=by, library_ms=library_ms,
                    library=("torch.matmul(q.bfloat16(), emb.t()), TF32 off"
                             if cos_only else None))
        emit({"phase": "kernel", **line})
        if not ok:
            raise AssertionError(f"profile_kernel[{variant}] breaks the parity rule: {line}")
        out[variant] = line
        del got, want
        torch.cuda.empty_cache()
    return out


def int_mm_yardstick(q8, emb8) -> tuple[float | None, str]:
    """One PyTorch call's time for the int8 cosine product alone
    (``torch._int_mm``), where this build has one for these shapes: no single
    call computes a scan with its extraction."""
    import torch

    try:
        return time_ms(lambda: torch._int_mm(q8, emb8.t()), device_only=True), \
            "torch._int_mm(q8, emb8.t()): the int8 cosine product alone"
    except RuntimeError as exc:  # a yardstick only: record why there is none
        return None, f"none: torch._int_mm: {exc}"


def kw_mm_yardstick(kw_w8, bloom) -> tuple[float | None, str]:
    """One PyTorch call's time for K5's keyword product alone
    (``torch._int_mm`` of the keyword weights against the bit matrix,
    expanded beforehand to int8 [N, 8W], 1 GiB at the serving shape), where
    this build has one for these shapes."""
    import torch

    bits = torch.cat([(bloom >> s) & 1 for s in range(8)], dim=1).view(torch.int8)
    try:
        return time_ms(lambda: torch._int_mm(kw_w8, bits.t()), device_only=True), \
            "torch._int_mm(kw_w8, bits.t()): the keyword product alone, over the " \
            "pre-expanded int8 bit matrix"
    except RuntimeError as exc:  # a yardstick only: record why there is none
        return None, f"none: torch._int_mm: {exc}"
    finally:
        del bits
        torch.cuda.empty_cache()


def kw_sub512_line(bloom, kw_w8, kw_b, add_row) -> dict:
    """K5 at slices of 512 (t 4), where it takes its 64-query tile: its
    time, held bitwise against the plain version."""
    from omni_recall_tpu_torch.ops import scorer

    def kern():
        return scorer.block_topt_kw_only(bloom, kw_w8, kw_b, add_row, t=4, sub=512)

    ok = pair_bitwise(kern(), scorer.block_topt_kw_only_plain(bloom, kw_w8, kw_b, add_row,
                                                              t=4, sub=512))
    line = dict(sub=512, query_tile=scorer.int8_kw_query_tile(512, bloom.shape[1]),
                parity=bitwise_parity(ok), ms=time_ms(kern, device_only=True))
    if not ok:
        raise AssertionError(f"kw_scan at sub 512 disagrees with its plain version: {line}")
    return line


def t5_lines(g, emb8, bloom, q8, add_row) -> dict:
    """T5 on row and transposed bloom at the serving shapes (c 2048, the
    tool's 0/1 keyword weights), each bitwise against its plain version and
    the two against each other; beside the int8 cosine product alone
    (torch._int_mm), where this build has one for these shapes."""
    import torch

    from omni_recall_tpu_torch.tools import profile_bloomT as t5

    (n, d), b, w = emb8.shape, q8.shape[0], bloom.shape[1]
    kw8 = torch.randint(0, 2, (b, 8 * w), generator=g, device=emb8.device).to(torch.int8)
    layouts = {"row": (bloom, False), "transposed": (bloom.T.contiguous(), True)}
    library_ms, library = int_mm_yardstick(q8, emb8)
    bms, by = t5_bound(n, b, d, w)
    out, got = {}, {}
    for layout, (bl, transposed) in layouts.items():
        kern = lambda: t5.bloom_scan(emb8, bl, q8, kw8, add_row, transposed, t5.C)  # noqa: E731, B023
        got[layout] = kern()
        want, plain_ms = plain_once(
            lambda: t5.bloom_scan_plain(emb8, bl, q8, kw8, add_row, transposed, t5.C))  # noqa: B023
        ok = bitwise(got[layout], want)
        line = dict(name=f"profile_bloomT[{layout}]", replaces="tools/profile_bloomT.py:22",
                    shape=[b, n, d], bits=8 * w, c=t5.C, out_shape=list(want.shape),
                    parity=bitwise_parity(ok),
                    max_abs_err=float((got[layout] - want).abs().max()),
                    ms=time_ms(kern, device_only=True), plain_ms=plain_ms, plain_runs=1,
                    bound_ms=bms, bound_by=by, library_ms=library_ms, library=library)
        emit({"phase": "kernel", **line})
        if not ok:
            raise AssertionError(f"profile_bloomT[{layout}]: kernel disagrees with its "
                                 "plain version")
        out[layout] = line
        del want
    if not bitwise(got["row"], got["transposed"]):
        raise AssertionError("profile_bloomT: the row and transposed layouts disagree")
    del layouts, got
    torch.cuda.empty_cache()
    return out


def coarse_bound(n: int, b: int, d: int, terms: int, out_bytes: int) -> tuple[float, str]:
    """K1's least time, and so T2's and T4's: int8 rows and queries and
    ``terms`` f32 terms a row and a query (K1 and T2: add_row, scale_row,
    q_scale, q_bias; T4: scale, qs) read once, the output written once;
    2 int8 operations a product term."""
    return bound_ms(n * d + b * d + 4 * terms * (n + b) + out_bytes, 2.0 * n * d * b,
                    INT8_OPS_PER_S)


def t2_out_bytes(n: int, b: int, sub: int, t: int) -> int:
    return b * (n // sub) * (t + 1) * 8


def t4_out_bytes(n: int, b: int, sub: int, t1: int, emit: str) -> int:
    return b * (n // sub) * t1 * (8 if emit == "pair" else 4)


T2_LAYOUTS = {"serving": (1024, 2), "tool": (512, 4)}  # (sub, t), c = sub
T4_BODY_LINE = {"pair": 123, "p3": 136, "pf": 142}  # tools/probe_keys_emit.py


def t2_lines(emb8, q8, add_row, scale_row, q_scale, q_bias) -> dict:
    """T2 at K1's serving layout (sub 1024, t 2) and at the tool's (512, 512,
    t 4), over the K1 line's operands: bitwise against its plain version and
    against K1's kernel on the same operands (K1 folds the 0.7 weight
    itself), with K1 timed before and after it, and K1 at t = 0 (one maximum
    a slice, the least extraction there is) beside them: K1 less that is
    what its extraction rounds cost; and T2 at t = 0 likewise, so that T2
    less that is what its rounds add once they run beside the dot."""
    import torch

    from omni_recall_tpu_torch.ops import scorer
    from omni_recall_tpu_torch.ops.oracle import COSINE_WEIGHT
    from omni_recall_tpu_torch.tools import probe_pipe as t2

    (n, d), b = emb8.shape, q8.shape[0]
    args = (emb8, q8, add_row, scale_row, COSINE_WEIGHT * q_scale, q_bias)
    library_ms, library = int_mm_yardstick(q8, emb8)
    out = {}
    for layout, (sub, t) in T2_LAYOUTS.items():
        kern = lambda: t2.pipe_scan(*args, t, sub, sub)  # noqa: E731, B023
        plain = lambda: t2.pipe_scan_plain(*args, t, sub, sub)  # noqa: E731, B023
        k1 = lambda: scorer.block_topt_int8_coarse(  # noqa: E731
            emb8, q8, add_row, scale_row, q_scale, q_bias, t=t, sub=sub, block=sub)  # noqa: B023
        (kv, ki), (pv, pi), (rv, ri) = kern(), plain(), k1()
        torch.cuda.synchronize()
        ok = bitwise(kv, pv) and bitwise(ki, pi)
        k1_ok = (bitwise(kv.transpose(0, 1).reshape(rv.shape), rv)
                 and bitwise(ki.transpose(0, 1).reshape(ri.shape), ri))
        k1_ms = time_ms(k1, device_only=True)
        ms = time_ms(kern, device_only=True)
        k1_max_only_ms = time_ms(lambda: scorer.block_topt_int8_coarse(  # noqa: B023
            emb8, q8, add_row, scale_row, q_scale, q_bias, t=0, sub=sub, block=sub),
            device_only=True)
        max_only_ms = time_ms(lambda: t2.pipe_scan(*args, 0, sub, sub),  # noqa: B023
                              device_only=True)
        bms, by = coarse_bound(n, b, d, 2, t2_out_bytes(n, b, sub, t))
        line = dict(name=f"probe_pipe[{layout}]", replaces="tools/probe_pipe.py:34",
                    shape=[b, n, d], layout=[sub, t], c=sub, out_shape=list(kv.shape),
                    query_tile=t2.query_tile(d, sub),
                    k1_query_tile=scorer.int8_query_tile(sub, d), warpgroups=t2.WARPGROUPS,
                    parity=bitwise_parity(ok), k1_bitwise=k1_ok,
                    max_abs_err=float((kv - pv).abs().max()), ms=ms, k1_ms=k1_ms,
                    k1_ms_after=time_ms(k1, device_only=True), k1_max_only_ms=k1_max_only_ms,
                    max_only_ms=max_only_ms,
                    plain_ms=time_ms(plain), plain_runs=5, bound_ms=bms, bound_by=by,
                    library_ms=library_ms, library=library)
        emit({"phase": "kernel", **line})
        if not ok:
            raise AssertionError(f"probe_pipe[{layout}]: kernel disagrees with its plain version")
        if not k1_ok:
            raise AssertionError(f"probe_pipe[{layout}]: kernel disagrees with K1's kernel")
        out[layout] = line
        del kv, ki, pv, pi, rv, ri
        torch.cuda.empty_cache()
    return out


def t4_lines(dev, seed: int) -> dict:
    """T4's three emits over the tool's operands (random bits as int8, so
    -128 occurs; scale and qs 1e-4) at B = 448, c = sub = 1024, t1 = 3, each
    bitwise against its plain version, P3 decoded against pair's values."""
    import torch

    from omni_recall_tpu_torch.ops import scorer
    from omni_recall_tpu_torch.tools import probe_keys_emit as t4

    emb8, q8, scale, qs = t4.tool_inputs(N_ROWS, BATCH, dev, seed)
    (n, d), b = emb8.shape, q8.shape[0]
    c, sub, t1 = t4.C, t4.SUB, t4.T1
    library_ms, library = int_mm_yardstick(q8, emb8)
    out, got = {}, {}
    for emit_name in t4.EMITS:
        kern = lambda: t4.keys_scan(emb8, q8, scale, qs, c, sub, t1, emit_name)  # noqa: E731, B023
        plain = lambda: t4.keys_scan_plain(emb8, q8, scale, qs, c, sub, t1, emit_name)  # noqa: E731, B023
        k, p = kern(), plain()
        torch.cuda.synchronize()
        k, p = (k, p) if emit_name == "pair" else ((k,), (p,))
        ok = all(bitwise(x, y) for x, y in zip(k, p))
        got[emit_name] = k
        # the values the keys stand for (decoded as the tool decodes P3)
        kv, pv = (k[0], p[0]) if emit_name == "pair" else (t4.decode_up(k[0], sub),
                                                           t4.decode_up(p[0], sub))
        bms, by = coarse_bound(n, b, d, 1, t4_out_bytes(n, b, sub, t1, emit_name))
        ms = time_ms(kern, device_only=True)
        line = dict(name=f"probe_keys_emit[{emit_name}]",
                    replaces=f"tools/probe_keys_emit.py:{T4_BODY_LINE[emit_name]}",
                    shape=[b, n, d], c=c, sub=sub, t1=t1, out_shape=list(k[0].shape),
                    query_tile=scorer.int8_query_tile(sub, d),
                    parity=bitwise_parity(ok), max_abs_err=float((kv - pv).abs().max()),
                    ms=ms, plain_ms=time_ms(plain), plain_runs=5,
                    bound_ms=bms, bound_by=by, library_ms=library_ms, library=library)
        emit({"phase": "kernel", **line})
        if not ok:
            raise AssertionError(f"probe_keys_emit[{emit_name}]: kernel disagrees with its "
                                 "plain version")
        out[emit_name] = line
        del p, kv, pv
    if not bitwise(t4.decode_up(got["p3"][0], sub), got["pair"][0]):
        raise AssertionError("probe_keys_emit: P3 decoded differs from pair's values")
    del emb8, q8, got
    torch.cuda.empty_cache()
    return out


def profile_path(paths: dict) -> dict:
    """The profiling path: the four tools' own sweeps at their shapes, run
    with the launch counts zeroed just before and read just after. Each
    record gets its bound; the per-configuration launches must add up to the
    path's, and T2's check against K1 must hold."""
    from omni_recall_tpu_torch.tools import (
        probe_keys_emit,
        probe_pipe,
        profile_bloomT,
        profile_kernel,
    )

    configs = (len(profile_kernel.VARIANTS) * len(profile_kernel.BLOCKS)
               + len(profile_bloomT.CONFIGS) + len(probe_pipe.CONFIGS)
               + len(probe_keys_emit.EMITS))
    t1_rec, t5_rec, t2_rec, t4_rec = run_path(
        paths, "profile", configs,
        lambda: (profile_kernel.main("all"), profile_bloomT.main(), probe_pipe.main(),
                 probe_keys_emit.main()))
    for r in t1_rec:
        r["bound_ms"], r["bound_by"] = t1_bound(r["variant"], profile_kernel.N,
                                                profile_kernel.B, profile_kernel.D,
                                                profile_kernel.BITS // 8, r["c"])
    for r in t5_rec:
        r["bound_ms"], r["bound_by"] = t5_bound(profile_bloomT.N, r["b"], profile_bloomT.D,
                                                r["bits"] // 8)
    for r in t2_rec:
        r["bound_ms"], r["bound_by"] = coarse_bound(
            probe_pipe.N, probe_pipe.B, probe_pipe.D, 2,
            t2_out_bytes(probe_pipe.N, probe_pipe.B, r["sub"], r["t"]))
    for r in t4_rec:
        r["bound_ms"], r["bound_by"] = coarse_bound(
            probe_keys_emit.N, probe_keys_emit.B, probe_keys_emit.D, 1,
            t4_out_bytes(probe_keys_emit.N, probe_keys_emit.B, r["sub"], r["t1"], r["emit"]))
    check = t2_rec[probe_pipe.CONFIGS.index(probe_pipe.CHECK)]
    if not (check["k1_vals_equal"] and check["k1_idxs_equal"]):
        raise AssertionError(f"profile: probe_pipe disagrees with K1 ({check})")
    launches = paths["profile"]["launches"]
    for key, recs in (("profile_kernel", t1_rec), ("profile_bloomT", t5_rec),
                      ("probe_pipe", t2_rec), ("probe_keys_emit", t4_rec)):
        if sum(r["launches"] for r in recs) != launches[key]:
            raise AssertionError(f"profile: {key} records do not add up to the path's "
                                 f"launches ({launches})")
    line = {"phase": "profile", "profile_kernel": t1_rec, "profile_bloomT": t5_rec,
            "probe_pipe": t2_rec, "probe_keys_emit": t4_rec, "launches": launches}
    emit(line)
    return line


def probe_serve_path(paths: dict) -> dict:
    """The serving-stage decomposition: the tool's stage sweep at its shapes,
    run with the launch counts zeroed just before and read just after. Every
    stage must have a positive finite time, the records' T3 launches must add
    up to the path's, and the scan's candidate bounds must come sorted."""
    import math

    import torch

    from omni_recall_tpu_torch.tools import probe_serve

    records = run_path(paths, "probe_serve", len(probe_serve.LABELS), probe_serve.main)
    torch.cuda.empty_cache()
    launches = paths["probe_serve"]["launches"]
    if not all(0 < r["ms"] < math.inf for r in records.values()):
        raise AssertionError(f"probe_serve: a stage has no time ({records})")
    if sum(r["launches"].get("probe_serve", 0) for r in records.values()) != \
            launches["probe_serve"]:
        raise AssertionError(f"probe_serve: records do not add up to the path's launches "
                             f"({launches})")
    if not records["S"]["sorted_desc"]:
        raise AssertionError("probe_serve: the scan's candidate bounds are not sorted")
    ms = {name: r["ms"] for name, r in records.items()}
    line = {"phase": "probe_serve", "stages": records, "launches": launches,
            "sum_tool_design_ms": ms["S"] + ms["G"] + ms["K"] + ms["T"] + ms["Q"],
            "sum_port_design_ms": ms["S"] + ms["R"]}
    emit(line)
    return line


# ---------------------------------------------------------------- phase 3


DOCS = {
    "gpu-notes.md": "# Hopper notes\nThe H100 streams device memory at terabytes per "
    "second. Tensor cores multiply int8 tiles; shared memory holds the working set of a "
    "block. Kernels written by hand control every rounding.",
    "recall.txt": "Certified exact recall ranks chunks by cosine similarity, keyword "
    "overlap and recency. The certificate compares the kth exact score with the largest "
    "upper bound of every excluded chunk.",
    "garden.txt": "Tomatoes need sun and steady water. Basil grows well beside them, and "
    "marigolds keep pests away from the garden beds in early summer.",
}
QUERIES = ["tensor cores int8", "exact certificate upper bound", "garden water basil",
           "recency keyword cosine", "shared memory block rounding"]


def server_phase() -> dict:
    import shutil
    import tempfile

    from omni_recall_tpu_torch.config import load_config

    snapshot_dir = tempfile.mkdtemp(prefix="omni_server_snapshot_")
    config = load_config(settings_file=None, env={}, overrides={
        "Engine:Backend": "pallas", "Engine:ScanDtype": "int8", "Engine:Refine": "true",
        "Engine:DirectSelect": "true", "Engine:DeviceExactCos": "true",
        "Engine:EmbeddingDim": DIM, "Engine:BloomBits": BITS,
        "Embeddings:Provider": "Hash", "Embeddings:Dim": DIM,
        "Storage:SnapshotDir": snapshot_dir,
        # with no provider keys, chat answers the reference's recall-only
        # fallback instead of a 503
        "ChatQuality:EnableRecallOnlyFallbackOnProviderFailure": "true",
    })
    try:
        with fixed_clock():  # the app's and the oracle's recency, to the bit
            return _server_checks(config)
    finally:
        shutil.rmtree(snapshot_dir, ignore_errors=True)


@contextlib.contextmanager
def fixed_clock():
    """One fixed clock for ingest and search (the port's own modules), so
    two searches made a moment apart score recency identically."""
    import omni_recall_tpu_torch.ingest.service as ingest_mod
    import omni_recall_tpu_torch.search.engine as engine_mod

    real = datetime.datetime

    class FixedClock(real):
        @classmethod
        def now(cls, tz=None):
            return real(2026, 9, 1, 12, 0, tzinfo=datetime.timezone.utc)

    ingest_mod.datetime = engine_mod.datetime = FixedClock
    try:
        yield
    finally:
        ingest_mod.datetime = engine_mod.datetime = real


def _server_checks(config) -> dict:
    from omni_recall_tpu_torch.config import EngineOptions
    from omni_recall_tpu_torch.contracts import to_wire
    from omni_recall_tpu_torch.search.engine import RecallEngine
    from omni_recall_tpu_torch.search.service import RecallSearchService
    from omni_recall_tpu_torch.server.app import build_app
    from omni_recall_tpu_torch.server.testing import TestClient

    app = build_app(config)  # device defaults to cuda
    client = TestClient(app)
    for name, text in DOCS.items():
        resp = client.upload("/api/documents/upload", filename=name, data=text.encode())
        if resp.status != 201:
            raise AssertionError(f"upload {name}: HTTP {resp.status}")
    oracle = RecallSearchService(
        RecallEngine(app.store, None, EngineOptions(
            backend="oracle", recent_window=config.engine.recent_window)),
        app.embedding_client,
    )
    citations = 0
    for q in QUERIES:
        resp = client.post("/api/recall/search", json_body={"query": q, "topK": 3})
        if resp.status != 200:
            raise AssertionError(f"search {q!r}: HTTP {resp.status}")
        got = resp.json()
        want = json.loads(json.dumps(to_wire(oracle.search(q, 3))))
        if got != want:
            raise AssertionError(f"search {q!r}: {got} != oracle {want}")
        citations += len(got["citations"])
    health = client.get("/health")
    chat = _chat_checks(config, app, client)
    pages = {}
    for path, kind in (("/swagger/v1/swagger.json", "application/json"),
                       ("/swagger", "text/html"), ("/", "text/html")):
        resp = client.get(path)
        if resp.status != 200 or not resp.headers.get("Content-Type", "").startswith(kind):
            raise AssertionError(f"GET {path}: HTTP {resp.status} {resp.headers}")
        pages[path] = len(resp.body)
    doc = client.get("/swagger/v1/swagger.json").json()
    if not {"/api/chat", "/api/recall/search", "/api/documents/train"} <= set(doc["paths"]):
        raise AssertionError(f"the OpenAPI document lacks routes: {sorted(doc['paths'])}")
    # snapshot persistence: POST /api/snapshot, then a second app on the
    # same Storage:SnapshotDir restores by the slab route
    if app.restore_route is not None:
        raise AssertionError(f"an empty snapshot directory restored: {app.restore_route}")
    saved = client.post("/api/snapshot", json_body={})
    if saved.status != 200:
        raise AssertionError(f"POST /api/snapshot: HTTP {saved.status}")
    saved = saved.json()
    chunks = sum(d.chunk_count for d in app.store.list_documents(2**31 - 1))
    if (saved["documents"], saved["chunks"]) != (len(DOCS), chunks):
        raise AssertionError(f"POST /api/snapshot: {saved}, want {len(DOCS)} documents, "
                             f"{chunks} chunks")
    again = build_app(config)
    restored = {"route": again.restore_route,
                "documents": len(again.store.list_documents(2**31 - 1)),
                "chunks": sum(d.chunk_count for d in again.store.list_documents(2**31 - 1)),
                "device_index_rows": again.engine.device_index.n_rows}
    if restored != {"route": "slabs", "documents": len(DOCS), "chunks": chunks,
                    "device_index_rows": app.engine.device_index.n_rows}:
        raise AssertionError(f"the restarted app restored {restored}")
    q = QUERIES[0]
    first = client.post("/api/recall/search", json_body={"query": q, "topK": 3}).json()
    second = TestClient(again).post("/api/recall/search", json_body={"query": q, "topK": 3})
    if second.status != 200 or second.json() != first:
        raise AssertionError(f"the restarted app answers {q!r} otherwise")
    line = {"phase": "server", "documents": len(DOCS), "searches": len(QUERIES) + 2,
            "citations": citations, "oracle_identical": True,
            "health": health.json()["status"], "chat": chat, "page_bytes": pages,
            "device_index_rows": app.engine.device_index.n_rows,
            "snapshot": {"saved": saved, "restored": restored, "same_search": True}}
    emit(line)
    return line


CHAT_PROMPT = QUERIES[1]


class ScriptedChat:
    """A chat client for the server check: it answers every grounded prompt
    citing snippets [1] and [2], and an out-of-range [9] the orchestration
    must drop."""

    def __init__(self):
        self.prompts = []

    def complete(self, request):
        from omni_recall_tpu_torch.contracts import AiChatResponse

        self.prompts.append(request.prompt)
        return AiChatResponse(text="The certificate compares bounds [1]  and widens [2] [9].",
                              model="scripted-1", provider="Scripted")


def _chat_checks(config, app, client) -> dict:
    """POST /api/chat twice: through an app sharing this one's store and
    engine with a scripted chat client injected as its ``chat_router`` (the
    answer's citations must be recall's [1] and [2]), and through this app's
    default remote chain, which has no provider keys and must answer the
    reference's recall-only fallback over recall's citations."""
    from omni_recall_tpu_torch.chat.orchestration import build_recall_only_fallback_answer
    from omni_recall_tpu_torch.server.app import build_app
    from omni_recall_tpu_torch.server.testing import TestClient

    body = {"prompt": CHAT_PROMPT, "topK": 3}
    recall = client.post("/api/recall/search", json_body={"query": CHAT_PROMPT, "topK": 3})
    recall = recall.json()["citations"]
    scripted = ScriptedChat()
    other = build_app(config, store=app.store, raw_store=app.raw_store, engine=app.engine,
                      embedding_client=app.embedding_client, chat_router=scripted)
    resp = TestClient(other).post("/api/chat", json_body=body)
    got = resp.json()
    if (resp.status != 200 or got["provider"] != "Scripted" or len(scripted.prompts) != 1
            or got["citations"] != recall[:2] or "[9]" in got["answer"]
            or "[1]" not in got["answer"] or recall[0]["snippet"] not in scripted.prompts[0]):
        raise AssertionError(f"scripted chat: HTTP {resp.status} {got}, recall {recall}")
    resp = client.post("/api/chat", json_body=body)
    fallback = resp.json()
    from omni_recall_tpu_torch.contracts import RecallCitation

    want = build_recall_only_fallback_answer(
        [RecallCitation(c["documentId"], c["fileName"], c["chunkId"], c["chunkIndex"],
                        c["snippet"], c["score"], None) for c in recall], config.chat_quality)
    if (resp.status != 200 or fallback["provider"] != "recall-only"
            or fallback["citations"] != recall or fallback["answer"] != want):
        raise AssertionError(f"default chat chain: HTTP {resp.status} {fallback}")
    return {"scripted": {"provider": got["provider"], "citations": len(got["citations"])},
            "default_chain": {"provider": fallback["provider"],
                              "citations": len(fallback["citations"])}}


# ---------------------------------------------------------------- phase 4


def build_corpus(seed: int, n: int, d: int):
    """Clustered corpus at serving scale (the recipe of the repository's
    end-to-end bench, rebuilt here): 64 rows per cluster spread across the
    index, unit rows = normalize(center + noise), cluster-token contents
    whose bloom signatures are the real ones, created days spread over a
    year. Returns (emb, assign, contents, created_days, centers)."""
    import numpy as np
    import torch

    n_clusters = max(4096, n // 64)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    centers = torch.randn((n_clusters, d), generator=g, device=dev)
    centers /= centers.norm(dim=1, keepdim=True)
    noise_k = 4096
    noise = torch.randn((noise_k, d), generator=g, device=dev) * (2.0 / d ** 0.5)
    rows = np.arange(n, dtype=np.int64)
    assign = (rows * 40503 + seed) % n_clusters
    emb = np.empty((n, d), dtype=np.float32)
    slab = 1 << 18
    for s0 in range(0, n, slab):
        cid = torch.from_numpy(assign[s0:s0 + slab]).to(dev)
        nid = torch.from_numpy(rows[s0:s0 + slab] % noise_k).to(dev)
        e = centers[cid] + noise[nid]
        e /= e.norm(dim=1, keepdim=True)
        emb[s0:s0 + slab] = e.cpu().numpy()
    contents = [f"topic c{c:05d}x synthetic chunk" for c in range(n_clusters)]
    return emb, assign, contents, corpus_created_days(n), centers.cpu().numpy()


def corpus_requests(centers, rseed: int, empty: bool = False, keyword_led: int = 0):
    """One batch of BATCH queries over a ``build_corpus`` corpus: each query
    near a cluster center, its text the cluster's token. ``keyword_led``:
    every such query's vector points nowhere near any cluster (a random
    direction), so only its words match — the cosine-only coarse
    certificate cannot hold for it."""
    import numpy as np

    n_clusters, d = centers.shape
    r = np.random.default_rng(rseed)
    reqs = []
    for i in range(BATCH):
        c = int(r.integers(n_clusters))
        qn = r.standard_normal(d).astype(np.float32)
        if keyword_led and i % keyword_led == 0:
            q = qn
        else:
            q = centers[c] + 0.2 * qn / np.linalg.norm(qn)
        q = (q / np.linalg.norm(q)).astype(np.float32)
        reqs.append((f"c{c:05d}x", [] if empty else q, 10))
    return reqs


def corpus_created_days(n: int):
    """The corpus's created days: spread over a year, to 3 decimals."""
    import numpy as np

    return np.round(np.linspace(0.0, 365.0, n), 3).astype(np.float32)


# kernels each serving path must launch (the counts are zeroed just before
# a path and read just after it), and kernels it must not launch
PATH_KERNELS = {
    "server": ("coarse_scan", "dd_rows"),
    "embedding_batches": ("coarse_scan", "dd_rows"),
    "refine_select_batches": ("coarse_scan", "refine", "dd_rows"),
    "keyword_led_refine_batch": ("coarse_scan", "fused_scan", "refine"),
    "pair_emit_batch": ("coarse_pair",),
    "prepass_off_batch": ("fused_scan", "refine"),
    "empty_vector_batch": ("kw_scan",),
    "keyword_led_batch": ("coarse_scan", "fused_scan"),
    "bf16_batches": ("fp_scan",),
    "f32_batches": ("fp_scan",),
    "reference_default_batches": (),
    "profile": ("profile_kernel", "profile_bloomT", "probe_pipe", "probe_keys_emit"),
    "probe_serve": ("probe_serve", "coarse_scan", "refine", "dd_rows"),
    "snapshot": ("coarse_scan", "dd_rows"),
    "rebuild": ("coarse_scan", "dd_rows"),
    "compact": ("coarse_scan",),
    "localq": ("coarse_scan", "dd_rows"),
    "localq_mixed": ("coarse_scan", "dd_rows", "kw_scan"),
    "localq_trained": ("coarse_scan", "dd_rows"),
    "probe_localq": ("coarse_scan",),
    # the train route itself searches nothing: its kernels are the
    # searches'. A tuple is "one of": whether a search starts with K1 or
    # goes straight to K4 depends on the coarse gate, which the untrained
    # encoder's misses may close
    "train_searches_before": (("coarse_scan", "fused_scan"),),
    "train": (),
    "train_searches_after": (("coarse_scan", "fused_scan"),),
    "chat_local": (("coarse_scan", "fused_scan"),),
    "sweep_10m": ("coarse_scan",),
    "probe_rebuild": (),
    "bench_ingest": (),
    # the 4-shard engine: K1, K3 and K2's gathered entry on every shard each
    # batch, K4 in the keyword-led batch's rescue, K5 for empty vectors
    "sharded": ("coarse_scan", "refine", "dd_rows", "fused_scan", "kw_scan"),
    "probe_sharded_timing": ("coarse_pair",),
    # the eval path: the headline-option app (K4 + K3 at its m = 128), the
    # parity campaigns (K1, K3; K2 with the headline's features) and the
    # real corpus's device engine (K5 for the keyword-only provider, K4 and
    # K3 in its rescue)
    "eval": ("coarse_scan", "dd_rows", "refine", "fused_scan", "kw_scan"),
    # one headline batch under torch.profiler
    "eval_trace": ("coarse_scan", "dd_rows"),
    # the six stage probes: K4 (profile_int8), K1 and K7a (sweep_coarse at
    # t = 1, probe_scan_decomp), K3 and K2 (profile_refine,
    # probe_direct_serve)
    "decomp": ("coarse_scan", "coarse_pair", "fused_scan", "refine", "dd_rows"),
}
# the int8 kernels: an f32/bf16 index must not reach them
INT8_KERNELS = ("coarse_scan", "coarse_pair", "dd_rows", "refine", "fused_scan")
SERVING_KERNELS = INT8_KERNELS + ("kw_scan", "fp_scan")
PROBE_KERNELS = ("profile_kernel", "profile_bloomT", "probe_pipe", "probe_keys_emit",
                 "probe_serve")
_SERVING_FORBIDS = {
    # the capacity configuration has no residual planes (K3) and, since
    # the device-exact cosine needs them, no raw plane (K2)
    "keyword_led_batch": ("refine", "dd_rows"),
    "pair_emit_batch": ("coarse_scan",),
    # the compact configuration has neither the residual nor the raw plane
    "compact": ("refine", "dd_rows", "coarse_pair", "fp_scan"),
    "bf16_batches": INT8_KERNELS,
    "f32_batches": INT8_KERNELS,
    "sharded": ("coarse_pair", "fp_scan"),
    # backend xla: the plain-torch scorer, no kernel of the repository
    "reference_default_batches": SERVING_KERNELS,
}
# the profiling path reaches no serving kernel and not T3, no serving path a
# probe, and the stage decomposition nothing but T3, K1, K3 and K2
_OWN_FORBIDS = {
    "profile": SERVING_KERNELS + ("probe_serve",),
    # the host-only tools: the rebuild's stages and the ingest pipeline
    # launch no kernel, the 10M sweep K1 alone
    "probe_rebuild": SERVING_KERNELS + PROBE_KERNELS,
    "bench_ingest": SERVING_KERNELS + PROBE_KERNELS,
    "sweep_10m": tuple(k for k in SERVING_KERNELS if k != "coarse_scan") + PROBE_KERNELS,
    "probe_serve": ("coarse_pair", "fused_scan", "kw_scan", "fp_scan")
    + tuple(k for k in PROBE_KERNELS if k != "probe_serve"),
    # the timing probe's coarse scans run at t = 1: K7a alone
    "probe_sharded_timing": tuple(k for k in SERVING_KERNELS if k != "coarse_pair")
    + PROBE_KERNELS,
    "eval": ("fp_scan",) + PROBE_KERNELS,
    "decomp": ("kw_scan", "fp_scan") + PROBE_KERNELS,
}
PATH_FORBIDS = {
    name: _OWN_FORBIDS.get(name, _SERVING_FORBIDS.get(name, ()) + PROBE_KERNELS)
    for name in PATH_KERNELS
}
# the path whose launches a kernel's entry in the kernels line reports
HOME_PATH = {"coarse_scan": "embedding_batches", "coarse_pair": "pair_emit_batch",
             "dd_rows": "embedding_batches", "refine": "refine_select_batches",
             "fused_scan": "keyword_led_refine_batch", "kw_scan": "empty_vector_batch",
             "fp_scan": "bf16_batches", "profile_kernel": "profile",
             "profile_bloomT": "profile", "probe_pipe": "profile",
             "probe_keys_emit": "profile", "probe_serve": "probe_serve"}
KEYWORD_LED_EVERY = 8  # one query in 8 of the keyword-led batch


def run_path(paths: dict, name: str, batches: int, fn, stats=None):
    """Run one serving path with every launch count zeroed just before it
    and read just after; record its launches (and the engine's stats delta)
    under ``paths[name]``. Raises if a kernel of the path never launched, or
    one it must not use did."""
    from omni_recall_tpu_torch.ops import cuda

    s0 = dict(stats) if stats is not None else None
    cuda.reset_launches()
    out = fn()
    launches = dict(cuda.LAUNCHES)
    rec = {"batches": batches, "launches": launches}
    if stats is not None:
        rec["stats"] = {k: v - s0.get(k, 0) for k, v in stats.items() if v != s0.get(k, 0)}
    paths[name] = rec
    missing = [k for k in PATH_KERNELS[name]
               if not any(launches[x] for x in (k if isinstance(k, tuple) else (k,)))]
    if missing:
        raise AssertionError(f"path {name}: kernels never launched: {missing} ({rec})")
    extra = [k for k in PATH_FORBIDS.get(name, ()) if launches[k]]
    if extra:
        raise AssertionError(f"path {name}: launched kernels it must not: {extra} ({rec})")
    return out


def load_index(engine, emb, assign, contents, created_days, records: dict):
    """Bulk-load the corpus into ``engine``'s device index (real bloom
    signatures, exact created micros, contents arena) and upload it. The
    records, signatures and host columns are built once into ``records``
    and shared by every index of the run (all have the same bloom
    parameters); the indexes only read them."""
    import torch

    dix = engine.device_index
    key = (dix.bloom_bits, dix.ngram, dix.bloom_hashes)
    if key not in records:
        records[key] = corpus_records(emb, assign, contents, created_days, *key)
    sigs, meta, aux = records[key]
    dix.bulk_load(emb, sigs, created_days, meta, aux=aux)
    dev = dix.device_arrays()
    torch.cuda.synchronize()
    return {k: round(getattr(dev, k).numel() * getattr(dev, k).element_size() / 2**30, 3)
            for k in ("emb", "emb2", "raw", "bloom") if getattr(dev, k) is not None}


def corpus_records(emb, assign, contents, created_days, bloom_bits, ngram, bloom_hashes):
    """(bloom signatures, ChunkRecords, bulk_load's aux columns) of the corpus."""
    from datetime import timedelta

    import numpy as np

    from omni_recall_tpu_torch.index.device_index import EPOCH, to_micros
    from omni_recall_tpu_torch.index.records import ChunkRecord
    from omni_recall_tpu_torch.ops import hashing

    n = emb.shape[0]
    sigs = hashing.chunk_signatures_batch(
        [c.lower() for c in contents], bloom_bits, ngram, bloom_hashes)
    day_cache: dict = {}
    meta = []
    for i in range(n):
        day = float(created_days[i])
        when = day_cache.get(day)
        if when is None:
            when = day_cache[day] = EPOCH + timedelta(days=round(day, 3))
        meta.append(ChunkRecord(
            id=f"s:{i}", document_id="synthetic", chunk_index=i,
            content=contents[assign[i]], embedding=emb[i], created_at_utc=when, seq=i,
        ))
    millidays = np.round(created_days.astype(np.float64) * 1000.0).astype(np.int64)
    us = to_micros(EPOCH) + millidays * 86_400_000
    fixed = np.array(contents, dtype="S")
    aux = {
        "created_us": us, "created_ts": us.astype(np.float64) / 1e6,
        "seqs": np.arange(n, dtype=np.int64),
        "lower_arena": fixed[assign].tobytes(),
        "lower_off": np.arange(n + 1, dtype=np.int64) * fixed.dtype.itemsize,
    }
    return sigs[assign], meta, aux


def headline_options(n: int, refine: bool = True):
    """The bench headline's engine options (bench.py:392-417) with its
    serving layout, over n rows of DIM dims and BITS bloom bits."""
    from omni_recall_tpu_torch.config import EngineOptions

    return EngineOptions(
        backend="pallas", embedding_dim=DIM, recent_window=0, candidate_m=128,
        bloom_bits=BITS, scan_dtype="int8", capacity_block=max(8192, n // 64),
        device_exact_cos=True, direct_select=True, refine=refine,
        coarse_sub=1024, coarse_t=2,
    )


def dto(hits):
    """A query's hits as the DTO carries them: ids in order, 4-decimal scores."""
    return [(h.chunk.id, round(h.score, 4)) for h in hits]


def oracle_check(eng, reqs, results, positions, now) -> int:
    """Each sampled query's served hits against the exact float64 host scan
    of the engine's own index, DTO-identical; returns the count checked."""
    for i in positions:
        q, e, k = reqs[i]
        want = eng._search_full_host(q, e, k, 0, now)
        if dto(results[i]) != dto(want):
            raise AssertionError(f"query {q!r}: {dto(results[i])} != oracle {dto(want)}")
    return len(positions)


def split_batch(eng, reqs, now):
    """Serve one batch split where its time goes: host dispatch (query
    prep, launches), the wait for the device queue, host finalize
    (certification, rescue). Bypasses ``search_batch`` and its query count.
    Returns (results, seconds, breakdown)."""
    import torch

    torch.cuda.synchronize()
    t = time.perf_counter()
    ctx = eng._dispatch_device_batch(reqs, 0, now)
    t_dispatch = time.perf_counter()
    torch.cuda.synchronize()
    t_device = time.perf_counter()
    res = eng._finalize_device_batch(ctx)
    t_final = time.perf_counter()
    return res, t_final - t, {"dispatch_host_ms": (t_dispatch - t) * 1e3,
                              "device_wait_ms": (t_device - t_dispatch) * 1e3,
                              "finalize_host_ms": (t_final - t_device) * 1e3}


def serve_phase(seed: int, paths: dict, n_batches: int = 4, n_refine: int = 3,
                sample: int = 8, n_fp: int = 3, fp_sample: int = 4,
                trace: dict | None = None) -> dict:
    from datetime import timedelta

    import numpy as np
    import torch

    from omni_recall_tpu_torch.config import EngineOptions
    from omni_recall_tpu_torch.index.device_index import EPOCH
    from omni_recall_tpu_torch.index.store import InMemoryIngestionStore
    from omni_recall_tpu_torch.ops import native
    from omni_recall_tpu_torch.search.engine import RecallEngine

    t0 = time.perf_counter()
    n, d = N_ROWS, DIM
    emb, assign, contents, created_days, centers = build_corpus(seed, n, d)
    corpus_s = time.perf_counter() - t0

    def engine_for(refine: bool):
        # refine=False is the capacity configuration
        return RecallEngine(InMemoryIngestionStore(), options=headline_options(n, refine))

    t0 = time.perf_counter()
    engine = engine_for(True)
    # the host finalize (keyword rescore, hybrid rescore) must run in the
    # native library, not its pure-Python fallback, or the times below
    # measure the fallback
    if not (native.native_available() and native.rescore_available()):
        raise AssertionError("the native keyword library did not build or load")
    records: dict = {}
    resident = {"refine": load_index(engine, emb, assign, contents, created_days, records)}
    build_s = time.perf_counter() - t0
    now = EPOCH + timedelta(days=365.0)

    def make_requests(rseed: int, empty: bool = False, keyword_led: int = 0):
        return corpus_requests(centers, rseed, empty, keyword_led)

    checked = 0

    def check(eng, reqs, results, positions=None):
        nonlocal checked
        checked += oracle_check(eng, reqs, results,
                                range(sample) if positions is None else positions, now)

    batches = [make_requests(seed + i) for i in range(n_batches)]
    timing: dict = {}

    def embedding_batches():
        engine.search_batch(make_requests(seed + 1000), now=now)  # warm-up
        # serial batches timed back to back (the oracle checks come after,
        # so their host work does not sit between the timed batches)
        lat, serial = [], []
        for reqs in batches:
            t = time.perf_counter()
            serial.append(engine.search_batch(reqs, now=now))
            lat.append(time.perf_counter() - t)
        timing["lat"] = lat
        # the same batches through the pipelined executor (one batch's host
        # finalize overlaps the next batch's dispatch and scans)
        t = time.perf_counter()
        piped = engine.search_batches_pipelined(batches, now=now)
        timing["pipelined_s"] = time.perf_counter() - t
        for reqs, res, res_p in zip(batches, serial, piped):
            check(engine, reqs, res)
            if [dto(h) for h in res_p] != [dto(h) for h in res]:
                raise AssertionError("pipelined results differ from search_batch")
        # where one batch's time goes: host dispatch (query prep, launches),
        # the wait for the device queue, host finalize (certification,
        # rescue). The dispatch must not wait for the device: count the
        # synchronizing CUDA calls one dispatch makes with PyTorch's sync
        # debug mode, on its own batch, since the mode slows the host.
        timing["breakdown"] = breakdown(make_requests(seed + 401), make_requests(seed + 400))

    def breakdown(probe, reqs, eng=None, positions=None):
        eng = eng or engine
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("warn")
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            ctx = eng._dispatch_device_batch(probe, 0, now)
        torch.cuda.set_sync_debug_mode(0)
        dispatch_syncs = sum("synchronizing" in str(w.message) for w in caught)
        eng._finalize_device_batch(ctx)
        res, _, split = split_batch(eng, reqs, now)
        check(eng, reqs, res, positions)
        return {"dispatch_sync_calls": dispatch_syncs, **split}

    def refine_select_batches():
        """DirectSelect off, the reference's own selection: K3 refines the
        top-r scan candidates of every batch, then compact_select."""
        engine.options.direct_select = False
        try:
            reqs_all = [make_requests(seed + 200 + i) for i in range(n_refine)]
            lat, res_all = [], []
            for reqs in reqs_all:
                t = time.perf_counter()
                res_all.append(engine.search_batch(reqs, now=now))
                lat.append(time.perf_counter() - t)
            for reqs, res in zip(reqs_all, res_all):
                check(engine, reqs, res)
            timing["refine_select"] = {
                "certified_qps": n_refine * BATCH / sum(lat),
                "p50_batch_ms": statistics.median(lat) * 1e3,
                "batch_ms": [x * 1e3 for x in lat],
                "breakdown": breakdown(make_requests(seed + 301), make_requests(seed + 300)),
            }
        finally:
            engine.options.direct_select = True

    def one_batch(eng, key, reqs, positions=None):
        def go():
            t = time.perf_counter()
            res = eng.search_batch(reqs, now=now)
            timing[key] = (time.perf_counter() - t) * 1e3
            check(eng, reqs, res, positions)
        return go

    # the main path: warm-up + serial + pipelined + the two breakdown batches
    run_path(paths, "embedding_batches", 1 + 2 * n_batches + 2, embedding_batches,
             engine.stats)
    if trace is not None:
        # the eval path's device trace: one headline batch under
        # torch.profiler, while the direct gate is open (K1, then K2)
        trace.update(run_path(paths, "eval_trace", 1, lambda: eval_trace(
            engine, make_requests(seed + 900), now, check)))
    run_path(paths, "refine_select_batches", n_refine + 2, refine_select_batches,
             engine.stats)
    # the main path's misses: keyword-led queries fail the coarse
    # certificate, the wide rescue cannot resolve them (their rows are not
    # among the cosine candidates), and the rescue loop's fused scan (K4)
    # serves them, K3 refining its candidates. Their misses close the direct
    # gate, so the batches after it take the refine selection.
    every = KEYWORD_LED_EVERY
    led = list(range(0, BATCH, every))
    # oracle sample: keyword-led queries and the queries just after them
    led_sample = led[:sample] + [i + 1 for i in led[:sample]]
    run_path(paths, "keyword_led_refine_batch", 1, one_batch(
        engine, "keyword_led_refine_batch_ms", make_requests(seed + 700, keyword_led=every),
        led_sample), engine.stats)
    # the rescue loop's own K3 share: one launch for each fused rescue scan,
    # besides the selection's one launch when the gate was closed
    led_path = paths["keyword_led_refine_batch"]
    led_path["rescue_refine"] = (led_path["launches"]["refine"]
                                 - (0 if engine._last_select_direct else 1))
    if led_path["rescue_refine"] != led_path["launches"]["fused_scan"]:
        raise AssertionError(f"keyword_led_refine_batch: the rescue loop did not refine "
                             f"each fused rescue scan ({led_path})")
    # K1's value/index pair mode (K7a): a coarse layout at t = 1
    engine.options.coarse_sub, engine.options.coarse_t = 512, 1
    run_path(paths, "pair_emit_batch", 1,
             one_batch(engine, "pair_emit_batch_ms", make_requests(seed + 800)), engine.stats)
    engine.options.coarse_sub, engine.options.coarse_t = 1024, 2
    # the fused scan (K4, its candidates refined by K3) serves a full batch
    # when the prepass is off
    engine.options.coarse_prepass = False
    run_path(paths, "prepass_off_batch", 1,
             one_batch(engine, "prepass_off_batch_ms", make_requests(seed + 500)),
             engine.stats)
    engine.options.coarse_prepass = True
    # empty query vectors: the keyword-only scan (K5), and where such a
    # batch's time goes (the breakdown's own two batches)
    def empty_vector_batch():
        one_batch(engine, "empty_vector_batch_ms", make_requests(seed + 600, empty=True))()
        timing["empty_vector_breakdown"] = breakdown(make_requests(seed + 601, empty=True),
                                                     make_requests(seed + 602, empty=True))

    run_path(paths, "empty_vector_batch", 3, empty_vector_batch, engine.stats)
    timing["empty_vector_stats"] = paths["empty_vector_batch"]["stats"]
    direct_gate = {"select_direct_last": engine._last_select_direct,
                   "query_count": engine._direct_query_count,
                   "skip_until": engine._direct_skip_until}
    # the row-sharded engine over the same corpus, held to this one
    t0 = time.perf_counter()
    sharded_line = sharded_phase(engine, make_requests, check, now, seed, paths, timing)
    sharded_s = time.perf_counter() - t0
    del engine
    torch.cuda.empty_cache()

    # the capacity configuration: no residual planes, so the keyword-led
    # misses rescue through K4 alone
    t0 = time.perf_counter()
    capacity = engine_for(False)
    resident["no_refine"] = load_index(capacity, emb, assign, contents, created_days, records)
    capacity_build_s = time.perf_counter() - t0
    run_path(paths, "keyword_led_batch", 1, one_batch(
        capacity, "keyword_led_batch_ms", make_requests(seed + 700, keyword_led=every),
        led_sample), capacity.stats)
    del capacity
    torch.cuda.empty_cache()

    # f32/bf16 scan storage (K6: no coarse prepass, every embedding query
    # goes straight to the rescue loop's fused scan) and the reference's
    # defaults (backend xla over f32 storage: the plain-torch scorer). The
    # f32 pallas engine serves the index the reference-default engine built
    # for itself: the f32 layout both engines build (no residual or raw
    # plane), loaded once.
    fp_configs = {
        "bf16_batches": dict(backend="pallas", scan_dtype="bf16"),
        "reference_default_batches": {},
        "f32_batches": dict(backend="pallas", scan_dtype="f32"),
    }
    fp_timing: dict = {}
    shared = None
    for name, opts in fp_configs.items():
        t0 = time.perf_counter()
        options = EngineOptions(embedding_dim=d, recent_window=0, candidate_m=128,
                                bloom_bits=BITS, **opts)
        if name == "f32_batches":
            own = RecallEngine(InMemoryIngestionStore(), options=options).device_index
            layout = lambda x: (x.scan_dtype, x.refine, x.exact_cos, x.bloom_bits)  # noqa: E731
            if layout(own) != layout(shared):
                raise AssertionError(f"f32 layouts differ: {layout(own)} != {layout(shared)}")
            eng = RecallEngine(InMemoryIngestionStore(), shared, options)
            resident[name] = "the reference_default_batches index"
        else:
            eng = RecallEngine(InMemoryIngestionStore(), options=options)
            resident[name] = load_index(eng, emb, assign, contents, created_days, records)
        shared = eng.device_index if name == "reference_default_batches" else None
        build = time.perf_counter() - t0

        def fp_batches(eng=eng, name=name, build=build):
            eng.search_batch(make_requests(seed + 900), now=now)  # warm-up
            reqs_all = [make_requests(seed + 910 + i) for i in range(n_fp)]
            lat, res_all = [], []
            for reqs in reqs_all:
                t = time.perf_counter()
                res_all.append(eng.search_batch(reqs, now=now))
                lat.append(time.perf_counter() - t)
            for reqs, res in zip(reqs_all, res_all):
                check(eng, reqs, res, range(fp_sample))
            fp_timing[name] = {
                "options": {"backend": eng.options.backend,
                            "scan_dtype": eng.device_index.scan_dtype},
                "build_s": build, "certified_qps": n_fp * BATCH / sum(lat),
                "p50_batch_ms": statistics.median(lat) * 1e3,
                "batch_ms": [x * 1e3 for x in lat],
                # these batches launch no scan at dispatch: the rescue
                # loop's scan runs inside the finalize (host clock)
                "breakdown": breakdown(make_requests(seed + 921), make_requests(seed + 920),
                                       eng, range(fp_sample))}
        run_path(paths, name, 1 + n_fp + 2, fp_batches, eng.stats)
        del eng, fp_batches
        torch.cuda.empty_cache()
    del shared, records

    lat = timing.pop("lat")
    line = {
        "phase": "serve", "rows": n, "dim": d, "bloom_bits": BITS, "batch": BATCH,
        "config": "refine=True, direct_select=True, coarse (1024, 2), candidate_m=128",
        "resident_gib": resident, "corpus_s": corpus_s, "build_s": build_s,
        "capacity_build_s": capacity_build_s, "native_finalize": True,
        "batches": n_batches, "certified_qps": n_batches * BATCH / sum(lat),
        "pipelined_qps": n_batches * BATCH / timing.pop("pipelined_s"),
        "p50_batch_ms": statistics.median(lat) * 1e3,
        "batch_ms": [x * 1e3 for x in lat], **timing,
        "keyword_led_queries": len(led),
        "keyword_led_host_scans": {
            k: paths[k]["stats"].get("host_fallbacks_total", 0)
            for k in ("keyword_led_refine_batch", "keyword_led_batch")},
        "direct_gate": direct_gate, "fp_paths": fp_timing,
        "sharded": {k: sharded_line[k] for k in ("shards", "p50_batch_ms", "certified_qps")},
        "sharded_s": sharded_s,
        "oracle_checked": checked, "oracle_per_batch": sample,
        "oracle_per_fp_batch": fp_sample,
        "paths": {k: v for k, v in paths.items() if k != "server"},
    }
    emit(line)
    return line


# ---------------------------------------------------------------- phase 4i

SHARDS = 4           # shards of the row-sharded engine, all on the one card
SHARDED_BATCHES = 3  # timed embedding batches of the sharded path


def sharded_phase(engine, make_requests, check, now, seed: int, paths: dict,
                  single_timing: dict) -> dict:
    """The ``sharded`` path: the headline engine's corpus in a second engine
    row-sharded over ``SHARDS`` shards of the card (``shards_mesh(devices=
    [cuda:0] * 4)``, ~4.6 GiB beside the first engine's), built by the slab
    route of a snapshot restore (``load_slabs``: the first engine's host
    mirrors and its quantized planes, read back; the host quantizer's pass
    over 2^20 x 768 rows would take most of the path), serving embedding
    batches (K1, then refine_select_dd: K3 and
    K2's gathered entry on every shard), a keyword-led batch (its misses
    rescued by the shards' K4) and an empty-vector batch (K5). Every served
    DTO must equal the single-device engine's on the same requests, and each
    batch's oracle sample must pass. Then, outside the path's counts: the op
    parity of ``tools.sharded_check`` on a one-shard and the 4-shard mesh
    over the single-device engine's own planes, the two 10M-row shapes of
    tests/test_sharded.py, a one-rank NCCL group against the in-process
    collectives, and the ``probe_sharded_timing`` path."""
    import torch

    from omni_recall_tpu_torch.index.store import InMemoryIngestionStore
    from omni_recall_tpu_torch.parallel.mesh import shards_mesh
    from omni_recall_tpu_torch.search.engine import RecallEngine

    one = engine.device_index
    n = one.n_rows
    card = torch.device("cuda", torch.cuda.current_device())
    mesh = shards_mesh(devices=[card] * SHARDS)
    t0 = time.perf_counter()
    sh = RecallEngine(InMemoryIngestionStore(), options=headline_options(n), mesh=mesh)
    planes = one.device_arrays()
    sh.device_index.load_slabs(
        one.meta[:n], emb_norm=one.emb[:n], raw_emb=one.raw_emb[:n],
        raw_norm_sq=one.raw_norm_sq[:n], bloom=one.bloom[:n], created=one.created[:n],
        created_us=one.created_us[:n], created_ts=one.created_ts[:n], seqs=one.seqs[:n],
        lower_arena=bytes(one._arena), lower_off=one.content_off[:n + 1],
        converted={k: getattr(planes, k)[:n].cpu().numpy()
                   for k in ("emb", "scale", "err", "emb2", "scale2", "err2")})
    dev_s = sh.device_index.device_arrays()
    torch.cuda.synchronize()
    resident = {k: round(getattr(dev_s, k).numel() * getattr(dev_s, k).element_size()
                         / 2**30, 3) for k in ("emb", "emb2", "raw", "bloom")}
    build_s = time.perf_counter() - t0

    every = KEYWORD_LED_EVERY
    emb_reqs = [make_requests(seed + 1100 + i) for i in range(SHARDED_BATCHES)]
    led_reqs = make_requests(seed + 1200, keyword_led=every)
    empty_reqs = make_requests(seed + 1300, empty=True)
    # the single-device engine's answers, before the path's counts start
    want = [engine.search_batch(r, now=now) for r in (*emb_reqs, led_reqs, empty_reqs)]
    led = list(range(0, BATCH, every))
    out: dict = {}

    def serve():
        sh.search_batch(make_requests(seed + 1000), now=now)  # warm-up
        lat, got = [], []
        for reqs in emb_reqs:
            t = time.perf_counter()
            got.append(sh.search_batch(reqs, now=now))
            lat.append(time.perf_counter() - t)
        for key, reqs in (("keyword_led_batch_ms", led_reqs),
                          ("empty_vector_batch_ms", empty_reqs)):
            t = time.perf_counter()
            got.append(sh.search_batch(reqs, now=now))
            out[key] = (time.perf_counter() - t) * 1e3
        for reqs, res, res_1 in zip((*emb_reqs, led_reqs, empty_reqs), got, want):
            if [dto(h) for h in res] != [dto(h) for h in res_1]:
                raise AssertionError("sharded: served DTOs differ from the single-device engine")
        for reqs, res in zip(emb_reqs, got):
            check(sh, reqs, res)
        check(sh, led_reqs, got[-2], led[:8] + [i + 1 for i in led[:8]])
        check(sh, empty_reqs, got[-1])
        out.update(certified_qps=len(lat) * BATCH / sum(lat),
                   p50_batch_ms=statistics.median(lat) * 1e3, batch_ms=[x * 1e3 for x in lat])

    run_path(paths, "sharded", 1 + SHARDED_BATCHES + 2, serve, sh.stats)
    launches = paths["sharded"]["launches"]
    batches = paths["sharded"]["batches"]
    # each shard runs its own K1, K3 and K2 in every embedding batch
    for kernel in ("coarse_scan", "refine", "dd_rows"):
        if launches[kernel] < SHARDS * (1 + SHARDED_BATCHES):
            raise AssertionError(f"sharded: {kernel} launched {launches[kernel]} times, "
                                 f"fewer than {SHARDS} a batch")
    del sh
    torch.cuda.empty_cache()

    dev = engine.device_index.device_arrays()
    parity = sharded_op_parity(dev, seed)
    big = sharded_10m_lines(seed)
    nccl = nccl_line(dev, seed)
    probe = run_path(paths, "probe_sharded_timing", 1 + 8 + 8, probe_sharded_timing_once)
    line = {
        "phase": "sharded", "shards": SHARDS, "devices": [str(d) for d in mesh.devices],
        "rows": n, "dim": one.dim, "batch": BATCH,
        "config": "headline_options (refine, device-exact cosine, coarse (1024, 2), "
                  "candidate_m 128); the sharded engine takes the refine selection",
        "build": "load_slabs (the single-device engine's mirrors and planes)",
        "build_s": build_s, "resident_gib": resident, **out,
        "single_device": {
            "embedding_batches_p50_ms": statistics.median(single_timing["lat"]) * 1e3,
            "embedding_batches_qps": len(single_timing["lat"]) * BATCH
            / sum(single_timing["lat"]),
            "refine_select_p50_ms": single_timing["refine_select"]["p50_batch_ms"],
            "refine_select_qps": single_timing["refine_select"]["certified_qps"]},
        "launches": launches,
        "launches_per_embedding_batch": {k: v / batches for k, v in launches.items() if v},
        "stats": paths["sharded"]["stats"], "dto_identical": True,
        "op_parity": parity, "rows_10m": big, "nccl": nccl, "probe_sharded_timing": probe,
        "gpu": nvidia_smi(),
    }
    emit(line)
    return line


def sharded_op_parity(dev, seed: int) -> dict:
    """``tools.sharded_check.op_parity`` over the headline engine's own
    planes (2^20 rows) at the fused scan's engine layout (sub 512, t 4), on
    a one-shard mesh (every output bitwise) and the 4-shard mesh (top-m
    values and boundary bitwise, rows up to ties, a sound boundary,
    refine_select_dd bitwise)."""
    import torch

    from omni_recall_tpu_torch.parallel.mesh import shards_mesh
    from omni_recall_tpu_torch.tools import sharded_check

    card = dev.emb.device
    b, d, bits = BATCH, dev.emb.shape[1], 8 * dev.bloom.shape[1]
    g = torch.Generator(device=card).manual_seed(seed + 17)
    q = torch.randn((b, d), generator=g, device=card)
    q /= q.norm(dim=1, keepdim=True)
    kw = torch.where(torch.rand((b, bits), generator=g, device=card) < 0.02, 0.05, 0.0)
    inp = {"q": q, "kw": kw, "kw_b": torch.zeros(b, device=card), "q_raw": q * 1.7}
    out = {}
    for shards in (1, SHARDS):
        mesh = shards_mesh(devices=[card] * shards)
        rec = sharded_check.op_parity(mesh, dev, inp, m=128, t=4, sub=512, t_out=32, r=64)
        out[f"shards_{shards}"] = rec
        if not rec["ok"]:
            raise AssertionError(f"sharded op parity on {shards} shard(s): {rec}")
    return out


def sharded_10m_lines(seed: int) -> dict:
    """The two 10M-row tests of tests/test_sharded.py on the card, on 8
    shards of it: the xla scan's merge with the window starting in the
    middle of shard 4 (d 8, as the test) against the single-device xla
    scorer, and refine_select_dd with the DD over candidates spread across
    every shard (d 16: K3 reads rows of 16-byte multiples) bitwise the
    single-device ops."""
    import torch

    from omni_recall_tpu_torch.index.device_index import DeviceArrays, device_quantize
    from omni_recall_tpu_torch.ops import exact_cos, refine, xla_scorer
    from omni_recall_tpu_torch.parallel.mesh import row_sharding, shards_mesh
    from omni_recall_tpu_torch.parallel.sharded import ShardedScorer

    card = torch.device("cuda", torch.cuda.current_device())
    mesh = shards_mesh(devices=[card] * 8)
    n, bits, b, m = 10 * (1 << 20), 64, 2, 16
    g = torch.Generator(device=card).manual_seed(seed + 23)
    out = {"rows": n, "shards": 8}

    t0 = time.perf_counter()
    d = 8
    emb = torch.randn((n, d), generator=g, device=card)
    emb /= emb.norm(dim=1, keepdim=True)
    bloom = torch.randint(0, 256, (n, bits // 8), generator=g, device=card).to(torch.uint8)
    created = torch.linspace(0.0, 365.0, n, device=card)
    valid = torch.ones(n, dtype=torch.bool, device=card)
    valid[torch.randint(0, n, (1000,), generator=g, device=card)] = False
    q = torch.randn((b, d), generator=g, device=card)
    q /= q.norm(dim=1, keepdim=True)
    kw_w = torch.zeros((b, bits), device=card)
    kw_w[:, torch.randint(0, bits, (6,), generator=g, device=card)] = 0.17
    kw_b = torch.zeros(b, device=card)
    r0 = n // 2 + 12345  # the window starts in the middle of shard 4
    planes = [row_sharding(mesh, x) for x in (emb, bloom, created, valid)]
    gv, gi = ShardedScorer(mesh).score_topm(*planes, q, kw_w, kw_b, 365.0, r0, m=m, mode="xla")
    wv, wi = xla_scorer.score_topm(emb, bloom, created, valid, q, kw_w, kw_b, 365.0, r0, m=m)
    merge_ok = (bitwise(gv[:, :m].contiguous(), wv[:, :m].contiguous())
                and bitwise(gv[:, m].contiguous(), wv[:, m].contiguous())
                and bool((gi[:, :m] >= r0).all()) and bool(valid[gi[:, :m].long()].all())
                and all(set(gi[i, :m].tolist()) == set(wi[i, :m].tolist())
                        or torch.unique(gv[i, :m]).numel() < m for i in range(b)))
    out["merge"] = {"dim": d, "window_start": r0, "ok": merge_ok,
                    "seconds": time.perf_counter() - t0}
    del emb, planes
    if not merge_ok:
        raise AssertionError(f"sharded 10M merge: {out}")

    t0 = time.perf_counter()
    d, t_out, r = 16, 8, 16
    raw = torch.randn((n, d), generator=g, device=card)
    raw /= raw.norm(dim=1, keepdim=True)
    conv = device_quantize(raw, refine=True)
    dev = DeviceArrays(emb=conv["emb"], scale=conv["scale"], err=conv["err"],
                       emb2=conv["emb2"], scale2=conv["scale2"], err2=conv["err2"],
                       bloom=bloom, created=created, valid=torch.ones_like(valid), raw=raw)
    sdev = DeviceArrays(**{k: row_sharding(mesh, getattr(dev, k)) for k in (
        "emb", "bloom", "created", "valid", "scale", "err", "emb2", "scale2", "err2", "raw")})
    q = torch.randn((b, d), generator=g, device=card)
    q /= q.norm(dim=1, keepdim=True)
    q_raw = q * 1.7
    kw_w = torch.zeros((b, bits), device=card)
    kw_w[:, torch.randint(0, bits, (4,), generator=g, device=card)] = 0.25
    idxs = torch.stack([torch.randperm(n, generator=g, device=card)[:m] for _ in range(b)])
    idxs[0, :8] = torch.arange(8, device=card) * (n // 8) + 4321  # a row in every shard
    vals = torch.sort(torch.rand((b, m), generator=g, device=card) * 0.6 + 0.3,
                      dim=1, descending=True).values
    vals_full = torch.cat([vals, torch.full((b, 1), 0.25, device=card)], 1)
    idxs_full = torch.cat([idxs.to(torch.int32),
                           torch.full((b, 1), -1, dtype=torch.int32, device=card)], 1)
    rs, us, bs, hi, lo, sabs = ShardedScorer(mesh).refine_select_dd(
        sdev, q, kw_w, kw_b, 365.0, vals_full, idxs_full, t_out=t_out, r=r, q_raw=q_raw)
    r1, u1, b1 = refine.refine_select_from_scan(
        dev.emb, dev.scale, dev.emb2, dev.scale2, dev.err2, dev.bloom, dev.created, dev.valid,
        q, kw_w, kw_b, 365.0, vals_full, idxs_full, t_out=t_out, r=r)
    h1, l1, s1 = exact_cos.exact_cos_rows(dev.raw, r1, q_raw)
    live = (rs >= 0) & (us > float("-inf"))
    dd_ok = (bool(torch.equal(rs, r1)) and bitwise(us, u1) and bitwise(bs, b1)
             and all(bitwise(x[live], y[live]) for x, y in ((hi, h1), (lo, l1), (sabs, s1))))
    out["refine_select_dd"] = {"dim": d, "ok": dd_ok, "live_slots": int(live.sum()),
                               "seconds": time.perf_counter() - t0}
    del raw, conv, dev, sdev, bloom, created, valid
    torch.cuda.empty_cache()
    if not dd_ok:
        raise AssertionError(f"sharded 10M refine_select_dd: {out}")
    return out


def nccl_line(dev, seed: int) -> dict:
    """The collectives' ``torch.distributed`` form on a one-rank NCCL group
    (``initialize_multihost`` from a ``file://`` store in a temporary
    directory, so no port is needed) against their in-process form: the
    4-shard coarse scan's merge and refine_select_dd over the headline
    planes, bitwise."""
    import tempfile

    import torch
    import torch.distributed as dist

    from omni_recall_tpu_torch.parallel.distributed import default_group, initialize_multihost
    from omni_recall_tpu_torch.parallel.mesh import shards_mesh
    from omni_recall_tpu_torch.parallel.sharded import ShardedScorer
    from omni_recall_tpu_torch.tools.sharded_check import sharded_planes

    card = dev.emb.device
    b, d, bits = BATCH, dev.emb.shape[1], 8 * dev.bloom.shape[1]
    g = torch.Generator(device=card).manual_seed(seed + 29)
    q = torch.randn((b, d), generator=g, device=card)
    q /= q.norm(dim=1, keepdim=True)
    kw = torch.where(torch.rand((b, bits), generator=g, device=card) < 0.02, 0.05, 0.0)
    kw_b = torch.zeros(b, device=card)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        if not initialize_multihost(f"file://{tmp}/store", num_processes=1, process_id=0,
                                    backend="nccl"):
            raise AssertionError("initialize_multihost did not start the group")
        try:
            outs = []
            for group in (default_group(), None):
                mesh = shards_mesh(devices=[card] * SHARDS, group=group)
                ss, sdev = ShardedScorer(mesh), sharded_planes(mesh, dev)
                vals, idxs = ss.score_topm(sdev.emb, sdev.bloom, sdev.created, sdev.valid, q,
                                           kw, kw_b, 365.0, 0, m=128, mode="pallas_int8_coarse",
                                           t=2, sub=1024, scale=sdev.scale, err=sdev.err)
                sel = ss.refine_select_dd(sdev, q, kw, kw_b, 365.0, vals, idxs, t_out=32,
                                          r=64, q_raw=q * 1.7)
                outs.append((vals, idxs, *sel))
            torch.cuda.synchronize()
            backend = dist.get_backend()
        finally:
            dist.destroy_process_group()
    ok = all(bitwise(x, y) for x, y in zip(*outs))
    line = {"backend": backend, "world": 1, "shards": SHARDS, "bitwise": ok,
            "seconds": time.perf_counter() - t0}
    if not ok:
        raise AssertionError(f"one-rank NCCL collectives differ from the in-process ones: {line}")
    return line


def probe_sharded_timing_once() -> dict:
    """``tools.probe_sharded_timing`` at its shape on the 4-shard mesh."""
    import torch

    from omni_recall_tpu_torch.parallel.mesh import shards_mesh
    from omni_recall_tpu_torch.tools import probe_sharded_timing

    card = torch.device("cuda", torch.cuda.current_device())
    line = probe_sharded_timing.probe(shards_mesh(devices=[card] * SHARDS))
    torch.cuda.empty_cache()
    return line


# ---------------------------------------------------------------- phase 4b

SNAPSHOT_ROWS = 1 << 17  # the repository bench's restore size (bench.py:1748)
SNAPSHOT_DOCS = 8        # the corpus's rows, in order, make these documents
SNAPSHOT_BATCHES = 2
SNAPSHOT_SAMPLE = 8      # oracle-checked queries a batch
DELETED_DOC = "doc3"     # the document the rebuild path deletes


def snapshot_phase(seed: int, paths: dict) -> dict:
    """The ``snapshot`` and ``rebuild`` paths on a 2^17-row headline index
    (refine planes, device-exact cosine; the serve phase's corpus recipe,
    its rows in order making eight documents of a store, 2^14 rows each).

    snapshot: the source engine serves two batches; ``save_snapshot`` reads
    its device planes back, ``load_snapshot_full`` maps the archive and
    ``restore_engine`` must take the slab route into a fresh engine, whose
    batches must equal the source's DTO for DTO (and the oracle on the
    sample). A copy of the archive with its error-bound plane zeroed must
    take the rebuild and still serve the same results.
    rebuild: one document deleted from the restored engine, a batch served
    (its tombstones synced), ``rebuild_index`` must compact on the device;
    the planes must equal those of a fresh index bulk-loaded from the
    surviving chunks, bit for bit, and both must serve the same DTOs. (A
    sync re-quantizes the dirty capacity blocks on the host, whose bits
    differ from the device quantizer's of a full upload, both sound: the
    document spans whole capacity blocks, so only its own rows are
    re-quantized.)"""
    import shutil
    import tempfile
    from datetime import timedelta

    import numpy as np
    import torch

    from omni_recall_tpu_torch.index import snapshot
    from omni_recall_tpu_torch.index.device_index import EPOCH, PLANES
    from omni_recall_tpu_torch.index.records import DocumentRecord
    from omni_recall_tpu_torch.index.store import InMemoryIngestionStore
    from omni_recall_tpu_torch.search.engine import RecallEngine

    n = SNAPSHOT_ROWS
    options = headline_options(n)
    emb, assign, contents, created_days, centers = build_corpus(seed, n, DIM)
    sigs, meta, aux = corpus_records(emb, assign, contents, created_days,
                                     options.bloom_bits, options.ngram, options.bloom_hashes)
    store = InMemoryIngestionStore()
    per_doc = n // SNAPSHOT_DOCS
    if per_doc % options.capacity_block:
        raise AssertionError("a document must span whole capacity blocks")
    for i, c in enumerate(meta):
        c.document_id = f"doc{i // per_doc}"
    for k in range(SNAPSHOT_DOCS):
        store.upsert_document(DocumentRecord(id=f"doc{k}", file_name=f"doc{k}.txt",
                                             chunk_count=per_doc))
    store.upsert_chunks(meta)
    source = RecallEngine(store, options=options)
    source.device_index.bulk_load(emb, sigs, created_days, meta, aux=aux)
    source.device_index.device_arrays()
    torch.cuda.synchronize()
    now = EPOCH + timedelta(days=365.0)
    batches = [corpus_requests(centers, seed + 1100 + i) for i in range(SNAPSHOT_BATCHES)]
    line = {"phase": "snapshot", "rows": n, "dim": DIM, "bloom_bits": BITS,
            "documents": SNAPSHOT_DOCS, "batch": BATCH, "batches": SNAPSHOT_BATCHES,
            "oracle_per_batch": SNAPSHOT_SAMPLE, "oracle_checked": 0}

    def serve(eng):
        out = [eng.search_batch(reqs, now=now) for reqs in batches]
        for reqs, res in zip(batches, out):
            line["oracle_checked"] += oracle_check(eng, reqs, res, range(SNAPSHOT_SAMPLE), now)
        return [[dto(h) for h in res] for res in out]

    def timed(fn):
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t

    tmp = tempfile.mkdtemp(prefix="omni_snapshot_")
    try:
        def snapshot_path():
            want = serve(source)
            _, line["save_s"] = timed(lambda: snapshot.save_snapshot(
                store, tmp, device_index=source.device_index))
            (restored, aux_r), line["load_s"] = timed(lambda: snapshot.load_snapshot_full(tmp))
            line["deriv"] = aux_r["meta"]["slabs"]["deriv"]
            if line["deriv"] != "device":
                raise AssertionError(f"the save did not read the device planes back: {line}")
            fast = RecallEngine(restored, options=headline_options(n))
            line["route"], line["restore_s"] = timed(
                lambda: snapshot.restore_engine(restored, fast, aux=aux_r))
            if line["route"] != "slabs":
                raise AssertionError(f"the restore did not take the slab route: {line}")
            _, line["upload_s"] = timed(fast.device_index.device_arrays)
            if serve(fast) != want:
                raise AssertionError("the restored engine serves other results than the source")
            # one tampered plane: every error bound zeroed (understated)
            bad = dict(aux_r)
            bad["slabs"] = {**aux_r["slabs"], "e1": np.zeros_like(aux_r["slabs"]["e1"])}
            slow = RecallEngine(restored, options=headline_options(n))
            line["tampered_route"], line["tampered_restore_s"] = timed(
                lambda: snapshot.restore_engine(restored, slow, aux=bad))
            if line["tampered_route"] != "rebuild":
                raise AssertionError(f"the tampered copy did not take the rebuild: {line}")
            if serve(slow) != want:
                raise AssertionError("the rebuilt engine serves other results than the source")
            return restored, fast

        restored, fast = run_path(paths, "snapshot", 3 * SNAPSHOT_BATCHES, snapshot_path)
        for key in ("save", "load", "restore", "upload"):
            line[f"{key}_chunks_per_s"] = n / line[f"{key}_s"]

        def rebuild_path():
            restored.delete_document(DELETED_DOC)
            fast.on_document_deleted(DELETED_DOC)
            before = serve(fast)  # serves the tombstones and syncs them to the card
            route, line["rebuild_s"] = timed(fast.rebuild_index)
            line["rebuild_route"] = route
            if route != "device":
                raise AssertionError(f"the rebuild did not compact on the device: {line}")
            survivors = np.asarray([i for i in range(n)
                                    if meta[i].document_id != DELETED_DOC], dtype=np.int64)
            fresh = RecallEngine(restored, options=headline_options(n))
            fresh.device_index.bulk_load(emb[survivors], sigs[survivors],
                                         created_days[survivors], [meta[i] for i in survivors])
            a, b = fast.device_index.device_arrays(), fresh.device_index.device_arrays()
            m = len(survivors)  # pad rows past it differ by design (masked by valid)

            def same(k):
                x, y = getattr(a, k), getattr(b, k)
                if x is None or y is None:
                    return x is None and y is None
                return bitwise(x, y) if k == "valid" else bitwise(x[:m], y[:m])

            differ = [k for k in PLANES if not same(k)]
            if differ or fast.device_index.n_rows != m:
                raise AssertionError(f"rebuilt planes differ from a fresh index: {differ}")
            after = serve(fast)
            if after != before or after != serve(fresh):
                raise AssertionError("the rebuilt index serves other results than the "
                                     "tombstoned one or a fresh one")
            line.update(rebuild_rows=len(survivors), rebuild_planes="bitwise",
                        rebuild_chunks_per_s=len(survivors) / line["rebuild_s"])

        run_path(paths, "rebuild", 3 * SNAPSHOT_BATCHES, rebuild_path)
        # the rebuild's stages (omni_recall_tpu_torch/tools/probe_rebuild.py)
        # on the restored store: an engine with an empty index derives every
        # row, then compacts on the card
        from omni_recall_tpu_torch.tools import probe_rebuild

        probe = RecallEngine(restored, options=headline_options(n))
        line["probe_rebuild"] = run_path(paths, "probe_rebuild", 0,
                                         lambda: probe_rebuild.stages(probe))
        routes = [r["route"] for r in line["probe_rebuild"] if "route" in r]
        if routes != ["upload", "device"]:
            raise AssertionError(f"probe_rebuild: routes {routes}, want upload then device")
        del probe
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    line["paths"] = {k: paths[k] for k in ("snapshot", "rebuild", "probe_rebuild")}
    emit(line)
    return line


# ---------------------------------------------------------------- phase 4d


LOCALQ_ROWS = 1 << 20
LOCALQ_PER_CLUSTER = 24  # rows a cluster token (bench.py build_localq_engine)
LOCALQ_MIXED = 16        # queries of the mixed batch
LOCALQ_SEED_BATCH = 16   # text-only queries served under the seed-0 weights
LOCALQ_SAMPLE = 8        # oracle-checked queries a batch
LOCALQ_SLAB = 1 << 15    # corpus rows a forward


def localq_phase(seed: int, paths: dict) -> dict:
    """The ``localq`` path: the self-contained deployment
    (Embeddings:Provider=Local) on the bench headline's engine. The port's
    full-width encoder at its seed-0 init (the JAX package's
    ``init_params(PRNGKey(0))``: vocab 32768, d_model 256, 4 layers, 4
    heads, d_ff 1024, max_len 128, out 768, bf16 compute) embeds 2^20 chunk
    texts in slabs (``embed_rows``, the array form of ``embed_batch``; one
    slab is held bitwise to ``embed_batch``), the recipe of
    ``bench.py build_localq_engine``: "topic c{k}x note r{i}" with about 24
    rows a cluster token. The app attaches the client to the engine (the
    device-resident query pipeline). First one mixed batch, while the
    coarse gate is still open: device-embedded queries and explicit host
    vectors, assembled on the card for K1 and K2, and empty vectors (K5).
    Then the first 16 queries of a text-only batch naming a cluster and a
    row ("c{k}x r{i}"), timed split (under the seed-0 weights most need an
    exact host scan of 2^20 rows, ~0.36 s each). Then the bench's fine-tune
    of this encoder (``tools/localq.py finetune``: 600 AdamW steps of 256
    pairs "c{k}x" -> content), the corpus re-embedded and the index
    reloaded, and the whole batch of 448 served again, split
    (``localq_trained``). A sample of each batch must be DTO-identical to
    the exact float64 scan of every row, fed the query bits the engine's
    own forward materialized. Prints the forward's time a batch (CUDA
    events), the corpus encode rate, and for each set of weights certified
    QPS, the batch's time, the resolved share at the prepass and in all,
    escalation rounds, host scans and the launches of the path."""
    import gc

    import numpy as np
    import torch

    from omni_recall_tpu_torch.ingest.embedding import LocalEncoderEmbeddingClient
    from omni_recall_tpu_torch.tools import localq, median_ms

    gc.collect()
    torch.cuda.empty_cache()
    n = LOCALQ_ROWS
    n_clusters = n // LOCALQ_PER_CLUSTER
    client = LocalEncoderEmbeddingClient(DIM, seed=0)  # CUDA, the default config
    cfg = client.cfg
    line = {"phase": "localq", "rows": n, "dim": DIM, "bloom_bits": BITS, "batch": BATCH,
            "n_clusters": n_clusters, "encoder": dict(cfg.__dict__),
            "config": "headline: pallas int8, refine planes, direct selection, device-exact "
                      "cosine, coarse (1024, 2); Embeddings:Provider=Local, DeviceQuery",
            "gpu": nvidia_smi()}
    assign = np.random.default_rng(7).integers(0, n_clusters, size=n)
    contents = [f"topic c{assign[i]}x note r{i}" for i in range(n)]

    # the corpus, slab by slab (tokenize, forward on the card, read back)
    client.embed_rows(contents[:LOCALQ_SLAB])  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    emb = localq.encode(client, contents, LOCALQ_SLAB)
    line["corpus_encode_s"] = time.perf_counter() - t0
    line["corpus_chunks_per_s"] = n / line["corpus_encode_s"]
    probe = contents[:BATCH]
    batch_vecs = np.asarray([r.vector for r in client.embed_batch(probe)], dtype=np.float32)
    if not bitwise(torch.from_numpy(batch_vecs), torch.from_numpy(client.embed_rows(probe))):
        raise AssertionError("embed_batch and embed_rows differ on one slab")
    line["mean_offdiag_cosine"] = _unit_rows_check(emb, seed)

    def make_requests(rseed: int):
        r = np.random.default_rng(rseed)
        rows = r.integers(0, n, BATCH)
        return [(f"c{assign[i]}x r{i}", None, 10) for i in rows]

    served = _LocalqServer(client, emb, contents, line)
    # the forward of one batch of 448 query texts: on token ids already on
    # the card, and with the host's tokenization (embed_device)
    texts = [t for t, _, _ in make_requests(seed + 2999)]
    ids = torch.from_numpy(client._bucketed_ids(texts)).cuda()
    line["encoder_forward_ms"] = median_ms(lambda: client.encoder(ids), torch.device("cuda"),
                                           runs=5)
    line["embed_device_ms"] = median_ms(lambda: served.real_embed_device(texts),
                                        torch.device("cuda"), runs=5)
    line["encoder_shape"] = list(ids.shape)

    def mixed():
        """One batch: a quarter explicit host vectors (the client's own
        host embed), a quarter empty vectors (keyword-only, K5), the rest
        embedded on the card."""
        reqs = []
        for i, (q, _, k) in enumerate(make_requests(seed + 3200)[:LOCALQ_MIXED]):
            if i % 4 == 1:
                reqs.append((q, client.embed(q).vector, k))
            elif i % 4 == 2:
                reqs.append((q, [], k))
            else:
                reqs.append((q, None, k))
        served.forwards.clear()
        t = time.perf_counter()
        res = served.engine.search_batch(reqs, now=served.now)
        line["mixed_batch_ms"] = (time.perf_counter() - t) * 1e3
        if (len(served.forwards) != 1
                or served.forwards[0].shape[0] != sum(e is None for _, e, _ in reqs)):
            raise AssertionError("the mixed batch did not embed its text-only queries in "
                                 "one forward")
        return reqs, res, served.forwards[0]

    reqs, res, b = run_path(paths, "localq_mixed", 1, mixed, served.engine.stats)
    served.check(reqs, res, b, range(LOCALQ_SAMPLE))
    batch = make_requests(seed + 3001)
    line["seed_init"] = served.serve(paths, "localq", batch[:LOCALQ_SEED_BATCH])

    # the bench's fine-tune of this encoder, the corpus re-embedded, the
    # index reloaded, and the whole batch served again
    served.close()
    losses: list = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state = localq.finetune(cfg, assign, contents, device="cuda",
                            on_step=lambda i, loss: losses.append(loss))
    torch.cuda.synchronize()
    line["finetune"] = {"steps": localq.LQ_STEPS, "pairs": localq.LQ_PAIRS,
                        "s": time.perf_counter() - t0, "loss_first": float(losses[0]),
                        "loss_last": float(losses[-1])}
    client.swap_params(state, tag=f"localq-{localq.LQ_STEPS}")
    t0 = time.perf_counter()
    emb = localq.encode(client, contents, LOCALQ_SLAB)
    line["trained_encode_s"] = time.perf_counter() - t0
    line["trained_mean_offdiag_cosine"] = _unit_rows_check(emb, seed)
    served = _LocalqServer(client, emb, contents, line, prefix="trained_")
    line["trained"] = served.serve(paths, "localq_trained", batch)
    line.update(
        mixed_queries=LOCALQ_MIXED, mixed_stats=paths["localq_mixed"]["stats"],
        mixed_launches=paths["localq_mixed"]["launches"],
        reduced=f"the seed-init weights serve {LOCALQ_SEED_BATCH} of the batch's 448 "
                "queries (each needing an exact host scan of 2^20 rows costs ~0.36 s); "
                "one timed batch each",
        paths={k: paths[k] for k in ("localq", "localq_mixed", "localq_trained")})
    emit(line)
    served.close()
    del client, emb, contents
    gc.collect()
    torch.cuda.empty_cache()
    return line


def _unit_rows_check(emb, seed: int) -> float:
    """Every 1024th row finite and of unit norm; the mean off-diagonal
    cosine of 512 sampled rows."""
    import numpy as np

    norms = np.linalg.norm(emb[:: 1 << 10], axis=1)
    if not (np.isfinite(emb[:: 1 << 10]).all() and np.allclose(norms, 1.0, atol=1e-3)):
        raise AssertionError("the encoder's rows are not finite unit rows")
    rows = emb[np.random.default_rng(seed).integers(0, emb.shape[0], 512)].astype(np.float64)
    gram = rows @ rows.T
    return float((gram.sum() - np.trace(gram)) / (512 * 511))


class _LocalqServer:
    """The localq corpus in the headline index, the client attached as the
    app attaches it, its forwards recorded so the oracle is fed the bits
    the engine materialized."""

    def __init__(self, client, emb, contents, line, prefix: str = "") -> None:
        from datetime import timedelta

        import numpy as np

        from omni_recall_tpu_torch.config import load_config
        from omni_recall_tpu_torch.index.device_index import EPOCH
        from omni_recall_tpu_torch.index.store import InMemoryIngestionStore
        from omni_recall_tpu_torch.search.engine import RecallEngine
        from omni_recall_tpu_torch.server.app import build_app

        n = emb.shape[0]
        t0 = time.perf_counter()
        self.engine = RecallEngine(InMemoryIngestionStore(), options=headline_options(n))
        records: dict = {}
        line[prefix + "resident_gib"] = load_index(self.engine, emb, np.arange(n), contents,
                                                   corpus_created_days(n), records)
        line[prefix + "index_build_s"] = time.perf_counter() - t0
        config = load_config(settings_file=None, env={}, overrides={
            "Engine:Backend": "pallas", "Engine:ScanDtype": "int8", "Engine:Refine": "true",
            "Engine:DirectSelect": "true", "Engine:DeviceExactCos": "true",
            "Engine:EmbeddingDim": DIM, "Engine:BloomBits": BITS,
            "Embeddings:Provider": "Local", "Embeddings:Dim": DIM})
        self.app = build_app(config, engine=self.engine, embedding_client=client)
        if not (self.app.search_service.device_query
                and self.engine._device_embedder is client):
            raise AssertionError("the app did not attach the local encoder to the engine")
        self.client = client
        self.forwards: list = []
        self.real_embed_device = client.embed_device

        def recording(texts):
            out = self.real_embed_device(texts)
            self.forwards.append(out)
            return out

        client.embed_device = recording
        self.now = EPOCH + timedelta(days=365.0)
        self.checked = 0

    def check(self, reqs, results, bits, positions) -> None:
        """``bits``: the forward's rows of the batch's device-embedded
        queries, in request order."""
        dev_pos = [i for i, (q, e, _) in enumerate(reqs) if e is None and q.strip()]
        rows = bits.cpu().numpy()
        for i in positions:
            q, e, k = reqs[i]
            if e is None and q.strip():
                e = rows[dev_pos.index(i)].tolist()
            want = self.engine._search_full_host(q, e, k, 0, self.now)
            if dto(results[i]) != dto(want):
                raise AssertionError(f"localq query {q!r}: {dto(results[i])} != oracle "
                                     f"{dto(want)}")
        self.checked += len(positions)

    def serve(self, paths: dict, name: str, reqs) -> dict:
        """One text-only batch, split; its figures."""
        def go():
            self.forwards.clear()
            res, seconds, split = split_batch(self.engine, reqs, self.now)
            return res, self.forwards[0], seconds, split

        res, bits, seconds, split = run_path(paths, name, 1, go, self.engine.stats)
        t = time.perf_counter()
        self.check(reqs, res, bits, range(LOCALQ_SAMPLE))
        stats = paths[name]["stats"]  # the split batch bypasses search_batch's count
        b = len(reqs)
        return {"queries": b, "certified_qps": b / seconds, "p50_batch_ms": seconds * 1e3,
                "breakdown": split, "oracle_s": time.perf_counter() - t,
                "oracle_checked": LOCALQ_SAMPLE,
                "resolved_at_prepass": stats.get("coarse_resolved_total", 0) / b,
                "dd_resolved_share": stats.get("dd_resolved_total", 0) / b,
                "resolved_in_all": 1.0 - stats.get("host_fallbacks_total", 0) / b,
                "host_scans": stats.get("host_fallbacks_total", 0),
                "escalation_rounds": stats.get("escalation_rounds_total", 0),
                "stats": stats,
                "launches": {k: paths[name]["launches"][k]
                             for k in ("coarse_scan", "dd_rows", "refine", "fused_scan")}}

    def close(self) -> None:
        import gc

        import torch

        self.client.embed_device = self.real_embed_device
        self.app = self.engine = None
        gc.collect()
        torch.cuda.empty_cache()


def probe_localq_path(paths: dict) -> dict:
    """``omni_recall_tpu_torch.tools.probe_localq`` at the bench's own
    default: 2^16 rows, the bench's small encoder (``LQ_CFG``: vocab 8192,
    d_model 128, 2 layers) fine-tuned 600 steps, batches of 1536, three
    split and six pipelined."""
    from omni_recall_tpu_torch.tools import localq, probe_localq

    timings: dict = {}
    lines: list = []

    def go():
        engine, make_reqs, n, client = localq.build_localq_engine(timings=timings)
        out = probe_localq.probe(engine, make_reqs, emit=lines.append)
        return out, n, dict(client.cfg.__dict__)

    out, n, cfg = run_path(paths, "probe_localq", 9, go)
    line = {"phase": "probe_localq", "rows": n, "encoder": cfg, "setup": timings, **out,
            "stage_lines": len(lines), "launches": paths["probe_localq"]["launches"],
            "gpu": nvidia_smi()}
    emit(line)
    return line


# the train path: the route's corpus, its documents and its searches
TRAIN_ROWS = 1 << 14
TRAIN_DOC_CHUNKS = 32
TRAIN_SEARCHES = 64
TRAIN_SAMPLE = 8             # oracle-checked searches after the reindex
TRAIN_SMALL = dict(vocab_size=4096, d_model=64, n_layers=2, n_heads=4, d_ff=128,
                   max_len=32, out_dim=64)
TRAIN_PARITY_STEPS = 5
TRAIN_REPEAT_STEPS = 20


def train_phase(seed: int, paths: dict) -> dict:
    """The ``train`` path: the encoder's training on the card.

    First the parity check: a small config's first 5 steps
    (``inverse_cloze_finetune``, batches of 32) on the card and on the
    port's CPU path in this process, with the CPU tests' tolerances: in f32
    compute the first step's loss (the same weights) within 1e-5 relative
    and every step's within 1e-3 (the fine-tune's: AdamW turns last-bit
    differences of small gradients into whole steps), in bf16 every step's
    within 2e-3 (the bf16 loss's).
    Then the
    repeat check: the small config fine-tuned twice from one seed on the
    card; whether the two state dicts are bitwise equal. Then the route:
    the app with ``Embeddings:Provider=Local`` (the default, full-width
    encoder at its seed-0 init) and the headline engine; 2^14 chunks of the
    localq recipe's texts uploaded through ``/api/documents/upload`` in
    documents of 32 chunks; 64 searches "c{k}x" through
    ``/api/recall/search``; ``POST /api/documents/train`` (300 steps of 64
    pairs, as ``train_embedder`` builds them: each step's time by CUDA
    events, the loss at the first and the last step, the card's peak
    memory); the 64 searches again, 8 of them DTO-identical to the float64
    scan of the stored vectors fed the query bits the engine's forward
    materialized. Prints the train and reindex seconds, recall@10 of the
    known cluster (the share of the top 10 from the query's cluster) before
    and after, and the launches."""
    import gc

    import numpy as np
    import torch

    from omni_recall_tpu_torch.config import load_config
    from omni_recall_tpu_torch.models import encoder, finetune
    from omni_recall_tpu_torch.server.app import build_app
    from omni_recall_tpu_torch.server.testing import TestClient

    gc.collect()
    torch.cuda.empty_cache()
    line = {"phase": "train", "gpu": nvidia_smi()}
    rng = np.random.default_rng(seed + 5)
    small_contents = [" ".join(f"w{x}" for x in rng.integers(0, 600, rng.integers(4, 24)))
                      for _ in range(400)]
    parity = {}
    for dtype, tol in (("float32", 1e-5), ("bfloat16", 2e-3)):
        cfg = encoder.EncoderConfig(**TRAIN_SMALL, compute_dtype=dtype)
        runs = {}
        for where in ("cpu", "cuda"):
            losses: list = []
            finetune.inverse_cloze_finetune(small_contents, cfg, steps=TRAIN_PARITY_STEPS,
                                            seed=seed, batch=32, device=where,
                                            on_step=lambda i, loss: losses.append(loss))
            runs[where] = [float(x) for x in losses]
        rel = [abs(a - b) / abs(a) for a, b in zip(runs["cpu"], runs["cuda"])]
        steps_tol = max(tol, 1e-3)
        parity[dtype] = {"cpu": runs["cpu"], "cuda": runs["cuda"], "first_rel": rel[0],
                         "max_rel": max(rel), "tol_first": tol, "tol_steps": steps_tol}
        if not (rel[0] <= tol and max(rel) <= steps_tol):
            raise AssertionError(f"train parity ({dtype}): card {runs['cuda']} against the "
                                 f"CPU {runs['cpu']}")
    line["parity"] = parity
    cfg = encoder.EncoderConfig(**TRAIN_SMALL)
    twice = [finetune.inverse_cloze_finetune(small_contents, cfg, steps=TRAIN_REPEAT_STEPS,
                                             seed=seed, batch=32)
             for _ in range(2)]
    line["repeat"] = {"steps": TRAIN_REPEAT_STEPS,
                      "bitwise": all(bitwise(twice[0][k], twice[1][k]) for k in twice[0]),
                      "max_abs_diff": max(float((twice[0][k] - twice[1][k]).abs().max())
                                          for k in twice[0])}
    del twice

    # the route
    n = TRAIN_ROWS
    n_clusters = n // LOCALQ_PER_CLUSTER
    assign = np.random.default_rng(7).integers(0, n_clusters, size=n)
    texts = [f"topic c{assign[i]}x note r{i}" for i in range(n)]
    config = load_config(settings_file=None, env={}, overrides={
        "Engine:Backend": "pallas", "Engine:ScanDtype": "int8", "Engine:Refine": "true",
        "Engine:DirectSelect": "true", "Engine:DeviceExactCos": "true",
        "Engine:EmbeddingDim": DIM, "Engine:BloomBits": BITS, "Engine:RecentWindow": 0,
        "Engine:CandidateM": 128, "Engine:CapacityBlock": 8192,
        "Embeddings:Provider": "Local", "Embeddings:Dim": DIM,
        "Ingestion:ChunkSizeWords": 4, "Ingestion:ChunkOverlapWords": 0})
    app = build_app(config)
    client = TestClient(app)
    emb_client = app.embedding_client
    line["encoder"] = dict(emb_client.cfg.__dict__)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for d0 in range(0, n, TRAIN_DOC_CHUNKS):
        body = " ".join(texts[d0:d0 + TRAIN_DOC_CHUNKS]).encode()
        resp = client.upload("/api/documents/upload", filename=f"lq{d0:06d}.txt", data=body)
        if resp.status != 201 or resp.json()["chunkCount"] != TRAIN_DOC_CHUNKS:
            raise AssertionError(f"upload {d0}: HTTP {resp.status} {resp.body[:200]}")
    line["upload_s"] = time.perf_counter() - t0
    line["documents"] = n // TRAIN_DOC_CHUNKS
    line["chunks"] = app.engine.device_index.n_rows
    qrng = np.random.default_rng(seed + 7)
    clusters = qrng.integers(0, n_clusters, TRAIN_SEARCHES)
    by_chunk = {}

    def searches():
        hits = []
        for k in clusters:
            resp = client.post("/api/recall/search", json_body={"query": f"c{k}x", "topK": 10})
            if resp.status != 200:
                raise AssertionError(f"search c{k}x: HTTP {resp.status}")
            cites = resp.json()["citations"]
            hits.append(np.mean([by_chunk.setdefault(
                c["chunkId"], c["snippet"]).split()[1] == f"c{k}x" for c in cites])
                if cites else 0.0)
        return float(np.mean(hits))

    line["recall_at_10_before"] = run_path(paths, "train_searches_before", 1, searches,
                                           app.engine.stats)
    real_finetune = finetune.inverse_cloze_finetune
    marks: dict = {}

    def timed_finetune(*a, **kw):
        events, losses = [], []

        def on_step(i, loss):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            events.append(ev)
            losses.append(loss)

        out = real_finetune(*a, **kw, on_step=on_step)
        torch.cuda.synchronize()
        steps = [events[i].elapsed_time(events[i + 1]) for i in range(len(events) - 1)]
        marks.update(trained=time.perf_counter(), step_ms=statistics.median(steps[1:]),
                     loss_first=float(losses[0]), loss_last=float(losses[-1]),
                     steps=len(losses), batch=kw.get("batch", 64))
        return out

    finetune.inverse_cloze_finetune = timed_finetune
    torch.cuda.reset_peak_memory_stats()
    try:
        def train():
            t = time.perf_counter()
            resp = client.post("/api/documents/train", json_body={})
            return resp, t, time.perf_counter()

        resp, t_start, t_end = run_path(paths, "train", 1, train, app.engine.stats)
    finally:
        finetune.inverse_cloze_finetune = real_finetune
    body = resp.json()
    if (resp.status != 200 or body["chunkCount"] != n or body["embeddedCount"] != n
            or body["failedCount"] != 0 or body["steps"] != config.embeddings.train_steps):
        raise AssertionError(f"POST /api/documents/train: HTTP {resp.status} {body}")
    line.update(train_s=marks["trained"] - t_start, reindex_s=t_end - marks["trained"],
                route_s=t_end - t_start, step_ms=marks["step_ms"], steps=marks["steps"],
                pairs_a_step=marks["batch"], loss_first=marks["loss_first"],
                loss_last=marks["loss_last"],
                peak_memory_gib=torch.cuda.max_memory_allocated() / 2**30,
                model=body["model"])
    # the 64 searches again; a sample against the float64 scan of the stored
    # vectors, fed the bits of the engine's own forward
    forwards: list = []
    real_embed_device = emb_client.embed_device
    emb_client.embed_device = lambda q: forwards.append(real_embed_device(q)) or forwards[-1]
    try:
        line["recall_at_10_after"] = run_path(paths, "train_searches_after", 1, searches,
                                              app.engine.stats)
    finally:
        emb_client.embed_device = real_embed_device
    if len(forwards) != TRAIN_SEARCHES:
        raise AssertionError(f"{len(forwards)} forwards for {TRAIN_SEARCHES} searches")
    now = datetime.datetime.now(datetime.timezone.utc)
    checked = 0
    for k, bits in list(zip(clusters, forwards))[:TRAIN_SAMPLE]:
        got = app.engine.search_batch([(f"c{k}x", bits[0].cpu().tolist(), 10)], now=now)[0]
        want = app.engine._search_full_host(f"c{k}x", bits[0].cpu().tolist(), 10, 0, now)
        if dto(got) != dto(want):
            raise AssertionError(f"trained search c{k}x: {dto(got)} != oracle {dto(want)}")
        checked += 1
    stored = app.store.get_chunks_by_document_id(app.store.list_documents(1)[0].id)
    line.update(oracle_checked=checked,
                stored_rows_trained=bool(np.isfinite(np.asarray(stored[0].embedding)).all()),
                launches={p: paths[p]["launches"] for p in (
                    "train_searches_before", "train", "train_searches_after")},
                search_stats={p: paths[p]["stats"] for p in (
                    "train_searches_before", "train_searches_after")},
                reduced="2^14 chunks (the bench's localq corpus holds 2^16); the route's "
                        "default 300 steps")
    emit(line)
    del app, client, emb_client
    gc.collect()
    torch.cuda.empty_cache()
    return line


CHAT_SLOTS = 4
CHAT_CHUNK = 16
CHAT_REQUESTS = 8
CHAT_DOCS = {
    "hopper.txt": "The H100 reads device memory at terabytes per second. Tensor cores "
                  "multiply int8 tiles and shared memory holds the working set of one block.",
    "recall.txt": "Certified exact recall ranks chunks by cosine similarity, keyword overlap "
                  "and recency, and widens the candidates when the certificate fails.",
    "garden.txt": "Tomatoes need sun and steady water. Basil grows beside them and "
                  "marigolds keep pests away from the beds in early summer.",
}


def chat_local_phase(paths: dict) -> dict:
    """The ``chat_local`` path: the app with ``Ai:Provider=Local`` (the
    seed-0 decoder at its default config: d_model 256, 4 layers, max_len
    640, bf16) and ``Embeddings:Provider=Local``; 8 concurrent ``POST
    /api/chat`` through the continuous batcher (4 slots, 16-token chunks,
    128 new tokens). Each stream the batcher served must be bit for bit the
    card's own ``generate`` for its prompt at the same attend window. Then
    prefill ms at each prompt bucket (batch 1), and the batcher's decode
    chunk at S = 4 live slots: ms a step and tokens/s (CUDA events)."""
    import gc
    import threading

    import numpy as np
    import torch

    from omni_recall_tpu_torch.config import load_config
    from omni_recall_tpu_torch.models import decoder
    from omni_recall_tpu_torch.server.app import build_app
    from omni_recall_tpu_torch.server.testing import TestClient

    config = load_config(settings_file=None, env={}, overrides={
        "Ai:Provider": "Local", "Ai:LocalWarmup": "false", "Ai:LocalSlots": CHAT_SLOTS,
        "Ai:LocalChunkTokens": CHAT_CHUNK,
        "Engine:Backend": "pallas", "Engine:ScanDtype": "int8", "Engine:Refine": "true",
        "Engine:DirectSelect": "true", "Engine:DeviceExactCos": "true",
        "Engine:EmbeddingDim": DIM, "Engine:BloomBits": BITS,
        "Embeddings:Provider": "Local", "Embeddings:Dim": DIM,
        "Ingestion:ChunkSizeWords": 12, "Ingestion:ChunkOverlapWords": 2,
        "ChatQuality:EnableRecallOnlyFallbackOnProviderFailure": "true"})
    app = build_app(config)
    client = TestClient(app)
    local = app.local_chat
    cfg, w = local.cfg, local.weights
    for name, text in CHAT_DOCS.items():
        if client.upload("/api/documents/upload", filename=name, data=text.encode()).status \
                != 201:
            raise AssertionError(f"upload {name}")
    words = " ".join(CHAT_DOCS.values()).split()
    prompts = [" ".join(words[6 * i: 6 * i + 12]) for i in range(CHAT_REQUESTS)]
    batcher = local._get_batcher()
    served: list = []
    real_submit = batcher.submit

    def recording(toks, seed, max_new):
        req = real_submit(toks, seed, max_new)
        served.append(req)
        return req

    batcher.submit = recording
    answers: dict = {}

    def ask(p):
        resp = client.post("/api/chat", json_body={"prompt": p, "topK": 3})
        answers[p] = (resp.status, resp.json())

    def go():
        threads = [threading.Thread(target=ask, args=(p,)) for p in prompts]
        t = time.perf_counter()
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=600)
        return time.perf_counter() - t

    seconds = run_path(paths, "chat_local", 1, go)
    batcher.submit = real_submit
    if len(served) != CHAT_REQUESTS or any(s != 200 for s, _ in answers.values()):
        raise AssertionError(f"chat_local: {len(served)} streams, "
                             f"{[s for s, _ in answers.values()]}")
    for req in served:
        bucket = batcher.bucket_for(len(req.toks), req.max_new)
        out = decoder.generate(w, decoder.pad_left_batch([req.toks], bucket), cfg,
                               req.max_new)[0].tolist()
        want = []
        for t in out:
            if t in (decoder.EOS, decoder.PAD):
                break
            want.append(t)
        if req.tokens != want[: req.max_new]:
            raise AssertionError(f"a batcher stream differs from generate(): {req.tokens[:16]} "
                                 f"against {want[:16]}")
    providers = sorted({a["provider"] for _, a in answers.values()})
    line = {"phase": "chat_local", "decoder": dict(cfg.__dict__), "requests": CHAT_REQUESTS,
            "slots": CHAT_SLOTS, "chunk": CHAT_CHUNK, "max_new": local.max_new_tokens,
            "streams_bitwise_generate": True, "providers": providers,
            "tokens": sum(len(r.tokens) for r in served), "chunks": batcher.chunks_run,
            "wall_s": seconds, "launches": paths["chat_local"]["launches"],
            "gpu": nvidia_smi()}
    # prefill at each bucket, batch 1; the decode chunk at S = 4 live slots
    rng = np.random.default_rng(0)
    line["prefill_ms"] = {}
    for bucket in (128, 256, 512):
        ids = torch.from_numpy(rng.integers(3, 259, size=(1, bucket))).cuda()
        line["prefill_ms"][bucket] = time_ms(lambda: decoder.prefill(w, ids, cfg))
    state = decoder.SlotState(cfg, CHAT_SLOTS, w.device)
    for s in range(CHAT_SLOTS):
        ids = rng.integers(3, 259, size=(1, 512))
        logits, cache = decoder.prefill(w, ids, cfg)
        decoder.insert_slot(state, cache, logits, ids, s, s, cfg)
    state.pos[:CHAT_SLOTS] = 512  # hold the positions: each timed chunk writes the same cells

    def chunk():
        state.done[:CHAT_SLOTS] = False
        state.pos[:CHAT_SLOTS] = 512
        decoder.decode_chunk(w, state, cfg, CHAT_CHUNK, 0.0, 640)

    chunk_ms = time_ms(chunk)
    line.update(decode_chunk_ms=chunk_ms, decode_ms_per_token_step=chunk_ms / CHAT_CHUNK,
                tokens_per_s_at_s4=CHAT_SLOTS * CHAT_CHUNK / chunk_ms * 1e3)
    emit(line)
    local.shutdown()
    del app, client, local, state
    gc.collect()
    torch.cuda.empty_cache()
    return line


INGEST_CHUNKS = 50_000


def bench_ingest_path(paths: dict) -> dict:
    """The ingest pipeline (omni_recall_tpu_torch/tools/bench_ingest.py) at
    50k chunks (its default is 100k): append and upload, f32 and int8
    storage."""
    from omni_recall_tpu_torch.tools import bench_ingest

    def go():
        return bench_ingest.measure(bench_ingest.chunks_of(INGEST_CHUNKS, DIM), DIM,
                                    __import__("torch").device("cuda"))

    line = {"phase": "bench_ingest", "gpu": nvidia_smi(),
            "records": run_path(paths, "bench_ingest", 0, go)}
    emit(line)
    return line


# ---------------------------------------------------------------- phase 4j

# the eval corpora's engines: the headline's features (pallas, int8, refine
# planes, direct selection, device-exact cosine) at the corpora's scale (the
# JAX parity test's m = 16 and capacity 512); the headline's own m = 128
# and (1024, 2) coarse layout need 2^16 rows or more, and at a few thousand
# rows every query would take K4
EVAL_JAX_SHAPES = dict(embedding_dim=64, bloom_bits=256, capacity_block=512, candidate_m=16)
EVAL_TRAIN_TOLERANCE = 0.03  # tests/test_torch_eval_quality.py: local-trained vs JAX


def eval_options(dim: int, bits: int, headline_features: bool = True):
    from omni_recall_tpu_torch.config import EngineOptions

    extra = dict(device_exact_cos=True, direct_select=True) if headline_features else {}
    return EngineOptions(backend="pallas", scan_dtype="int8", recent_window=0, refine=True,
                         **{**EVAL_JAX_SHAPES, "embedding_dim": dim, "bloom_bits": bits},
                         **extra)


class RecordingClient:
    """The eval harness's in-process client, keeping every recall response."""

    def __init__(self, app):
        from omni_recall_tpu_torch.eval.clients import InProcessClient

        self.inner = InProcessClient(app)
        self.recalls = []

    def search_recall(self, question, top_k):
        out = self.inner.search_recall(question, top_k)
        self.recalls.append((question, top_k, out))
        return out

    def __getattr__(self, name):
        return getattr(self.inner, name)


def eval_app_check(docs) -> dict:
    """The eval CLI's in-process run on the card: an app with the headline's
    engine options (``headline_options``) and Hash embeddings at 768 dims
    and 1024 bloom bits; the real corpus's documents uploaded through POST
    /api/documents/upload; the generated cases run through the harness;
    every recall response equal to an oracle-backend app's on the same
    store."""
    from omni_recall_tpu_torch.config import load_config
    from omni_recall_tpu_torch.eval.harness import EvalHarness, generate_cases
    from omni_recall_tpu_torch.index.store import InMemoryIngestionStore
    from omni_recall_tpu_torch.search.engine import RecallEngine
    from omni_recall_tpu_torch.server.app import build_app

    keys = {"Embeddings:Provider": "Hash", "Embeddings:Dim": DIM, "Engine:EmbeddingDim": DIM,
            "Engine:BloomBits": BITS, "Engine:RecentWindow": 0}
    config = load_config(settings_file=None, env={}, overrides=keys)
    store = InMemoryIngestionStore()
    engine = RecallEngine(store, options=headline_options(0))
    app = build_app(config, store=store, engine=engine)
    oracle_app = build_app(load_config(settings_file=None, env={}, overrides={
        **keys, "Engine:Backend": "oracle"}), store=store, embedding_client=app.embedding_client)
    client, oracle_client = RecordingClient(app), RecordingClient(oracle_app)
    t0 = time.perf_counter()
    for name, text in docs:
        resp = client.inner.client.upload("/api/documents/upload", filename=name,
                                          data=text.encode())
        if resp.status != 201:
            raise AssertionError(f"upload {name}: HTTP {resp.status}")
    upload_s = time.perf_counter() - t0
    cases = generate_cases(client)
    reports = {}
    for label, c in (("device", client), ("oracle", oracle_client)):
        t0 = time.perf_counter()
        reports[label] = EvalHarness(c, sleep=lambda s: None).run(cases)
        reports[label]["seconds"] = time.perf_counter() - t0
    if [r[2] for r in client.recalls] != [r[2] for r in oracle_client.recalls]:
        diff = next(i for i, (a, b) in enumerate(zip(client.recalls, oracle_client.recalls))
                    if a[2] != b[2])
        raise AssertionError(f"eval app: case {diff}'s recall differs from the oracle app's")
    strip = lambda rs: [{k: v for k, v in r.items() if k != "duration_ms"} for r in rs]  # noqa
    if strip(reports["device"]["results"]) != strip(reports["oracle"]["results"]):
        raise AssertionError("eval app: the harness reports differ from the oracle app's")
    return {"documents": len(docs), "chunks": engine.device_index.n_rows,
            "upload_s": upload_s, "cases": len(cases), "summary": reports["device"]["summary"],
            "recall_responses_equal": len(client.recalls),
            "citations": sum(len(r[2]["citations"]) for r in client.recalls),
            "harness_s": {k: r["seconds"] for k, r in reports.items()}}


def eval_parity_lines() -> dict:
    """The 200-case parity campaign of eval/corpus.py on the card at the JAX
    test's shapes (d 64, 256 bloom bits, its engine options) and at d 768 /
    1024 bits with the headline's features: every case DTO-identical to
    the float64 oracle."""
    from omni_recall_tpu_torch.eval.corpus import parity_campaign

    out = {}
    for label, dim, bits, headline in (("d64_jax_test", 64, 256, False),
                                       ("d768_headline_features", DIM, BITS, True)):
        t0 = time.perf_counter()
        before = dict(cuda_launches())
        rep = parity_campaign(eval_options(dim, bits, headline), device="cuda", dim=dim)
        if rep["mismatches"] or rep["hit_rate"] < 0.8:
            raise AssertionError(f"eval parity {label}: {len(rep['mismatches'])} mismatches, "
                                 f"hit rate {rep['hit_rate']} ({rep['mismatches'][:1]})")
        out[label] = {"cases": rep["cases"], "hit_rate": rep["hit_rate"], "mismatches": 0,
                      "seconds": time.perf_counter() - t0,
                      "launches": launch_delta(before)}
    return out


def cuda_launches() -> dict:
    from omni_recall_tpu_torch.ops import cuda

    return cuda.LAUNCHES


def launch_delta(before: dict) -> dict:
    return {k: v - before.get(k, 0) for k, v in cuda_launches().items()
            if v != before.get(k, 0)}


EVAL_CLOCK = datetime.datetime(2026, 9, 1, 12, 0, tzinfo=datetime.timezone.utc)


EVAL_CPU_THREADS = 4  # the CPU run's intra-op threads, beside the card's host thread


def cpu_real_corpus(docs_path: str) -> None:
    """The CPU run's process (``CpuCampaign``): the real-corpus campaign's
    fine-tuned provider (the gate) on this machine's CPU over the documents
    in ``docs_path``, on the fixed clock; prints one JSON line. The whole
    campaign there, beside the card's, took 171 s: none and hash score on
    the host in both runs (the same code), so only the fine-tune runs."""
    import torch

    from omni_recall_tpu_torch.eval import real_corpus
    from omni_recall_tpu_torch.eval.quality import encoder_embed_fn

    torch.set_num_threads(EVAL_CPU_THREADS)
    with open(docs_path, encoding="utf-8") as fh:
        docs = [tuple(d) for d in json.load(fh)]
    t0 = time.perf_counter()
    with fixed_clock():
        params, cfg = real_corpus.finetune_encoder_real(real_corpus.training_store(docs),
                                                        device="cpu")
        trained = real_corpus.recall_at_10(encoder_embed_fn(params, cfg, "cpu"), docs=docs,
                                           now=EVAL_CLOCK, device="cpu")
    print(json.dumps({"real_corpus_cpu": {"local-trained": trained},
                      "cpu_s": time.perf_counter() - t0}), flush=True)


class CpuCampaign:
    """The real-corpus campaign on the CPU in a process of its own (no CUDA
    device visible), started before the card's campaigns and run beside
    them; ``result`` waits for it, ``stop`` ends it and removes its files."""

    def __init__(self, docs):
        import tempfile

        self.dir = tempfile.mkdtemp(prefix="omni_eval_cpu_")
        path = os.path.join(self.dir, "docs.json")
        with open(path, "w", encoding="utf-8") as fh:
            json.dump(docs, fh)
        self.proc = subprocess.Popen(
            [sys.executable, "-c", f"import chip_smoke; chip_smoke.cpu_real_corpus({path!r})"],
            cwd=HERE, env={**os.environ, "CUDA_VISIBLE_DEVICES": ""},
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)

    def result(self, timeout: float = 600.0) -> dict:
        out, err = self.proc.communicate(timeout=timeout)
        if self.proc.returncode != 0:
            raise AssertionError(f"the CPU campaign failed ({self.proc.returncode}): "
                                 f"{err[-3000:]}")
        return json.loads(out.strip().splitlines()[-1])

    def stop(self) -> None:
        import shutil

        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()
        shutil.rmtree(self.dir, ignore_errors=True)


def eval_campaign_lines(docs, cpu_run: CpuCampaign) -> dict:
    """The real corpus's quality campaign (eval/real_corpus.py: four
    providers, 300 fine-tune steps) on the card, every query also served by
    the int8 engine at d 64 / 256 bits with the headline's features, its
    hits equal to the oracle's (so the keyword-only provider runs K5); and
    the fine-tuned provider's campaign on this machine's CPU (``cpu_run``,
    over the same rendering of the documents). Ingestion and recency run on one fixed
    clock. The fine-tuned encoder's recall on the card must be within
    EVAL_TRAIN_TOLERANCE of the CPU run's."""
    from omni_recall_tpu_torch.eval import real_corpus

    out = {}
    records: dict = {}
    before = dict(cuda_launches())
    t0 = time.perf_counter()
    with fixed_clock():
        out["real_corpus_cuda"] = real_corpus.evaluate_real_corpus(
            now=EVAL_CLOCK, device="cuda", device_options=eval_options(real_corpus.DIM, 256),
            records=records, docs=docs)
    out["real_corpus_cuda_s"] = time.perf_counter() - t0
    out["real_corpus_launches"] = launch_delta(before)
    bad = {p: r["mismatches"][:1] for p, r in records.items() if r["mismatches"]}
    if bad:
        raise AssertionError(f"real corpus: the int8 engine differs from the oracle: {bad}")
    out["real_corpus_device_engine"] = {
        p: {k: r[k] for k in ("queries", "oracle_recall", "device_recall")}
        for p, r in records.items()}
    t0 = time.perf_counter()
    out.update(cpu_run.result())
    out["cpu_wait_s"] = time.perf_counter() - t0
    card, cpu = out["real_corpus_cuda"], out["real_corpus_cpu"]
    out["trained_gap"] = abs(card["local-trained"] - cpu["local-trained"])
    if out["trained_gap"] > EVAL_TRAIN_TOLERANCE:
        raise AssertionError(f"real corpus: the fine-tuned recall on the card "
                             f"{card['local-trained']} is {out['trained_gap']} from the CPU "
                             f"run's {cpu['local-trained']}")
    return out


def eval_trace(engine, reqs, now, check) -> dict:
    """``utils/profiling.device_trace`` around one headline batch: the trace
    file must be written and name K1's and K2's kernels; its five longest
    device operations (by total time)."""
    import shutil
    import tempfile

    from omni_recall_tpu_torch.utils.profiling import device_ops, device_trace

    log_dir = tempfile.mkdtemp(prefix="omni_eval_trace_")
    try:
        with device_trace(log_dir) as trace:
            res = engine.search_batch(reqs, now=now)
        check(engine, reqs, res)
        size = os.path.getsize(trace.path)
        ops = device_ops(trace.path)
    finally:
        shutil.rmtree(log_dir, ignore_errors=True)
    names = {"coarse_scan": [o["name"] for o in ops if "int8_scan_kernel" in o["name"]],
             "dd_rows": [o["name"] for o in ops if "dd_rows_kernel" in o["name"]]}
    line = {"trace_bytes": size, "device_ops": len(ops),
            "device_us": sum(o["total_us"] for o in ops),
            "kernels_named": {k: bool(v) for k, v in names.items()},
            "kernel_names": {k: v[:2] for k, v in names.items()},
            "longest": ops[:5]}
    print(json.dumps({"eval_trace_longest": ops[:5]}), flush=True)
    if not all(names.values()):
        raise AssertionError(f"the device trace does not name K1 and K2: {line}")
    return line


def eval_phase(paths: dict, trace: dict) -> dict:
    """The eval path (ROADMAP 1.6 on the card): the eval CLI's in-process
    app, the parity campaign at two widths and the real corpus's quality
    campaign on the card and (in a process beside it) on the CPU, with the
    device trace taken in the serve phase (``trace``)."""
    from omni_recall_tpu_torch.eval import real_corpus

    line = {"phase": "eval", "gpu": nvidia_smi()}

    def go():
        docs = real_corpus.build_documents()
        cpu_run = CpuCampaign(docs)
        try:
            before = dict(cuda_launches())
            with fixed_clock():
                line["app"] = eval_app_check(docs)
            line["app"]["launches"] = launch_delta(before)
            line["parity"] = eval_parity_lines()
            line.update(eval_campaign_lines(docs, cpu_run))
        finally:
            cpu_run.stop()

    run_path(paths, "eval", 0, go)
    line["trace"] = trace
    line["launches"] = paths["eval"]["launches"]
    emit(line)
    return line


DECOMP_TOOLS = ("profile_int8", "sweep_coarse", "probe_scan_decomp", "profile_refine",
                "probe_direct_serve", "probe_gather_sorted")


def decomp_path(paths: dict) -> dict:
    """The six stage probes of tools/ (omni_recall_tpu_torch/tools), each
    ``main()`` at the tool's defaults (2^20 x 768 where the tool says so, B
    1536 where it does), every stage timed with CUDA events beside the host
    clock and its bound; each tool holds its stages against the whole path
    they split (``whole_path_equal``) and raises where they differ."""
    import importlib
    import math

    import torch

    line = {"phase": "decomp", "gpu": nvidia_smi(), "tools": {}}

    def go():
        for name in DECOMP_TOOLS:
            tool = importlib.import_module(f"omni_recall_tpu_torch.tools.{name}")
            before = dict(cuda_launches())
            t0 = time.perf_counter()
            records = tool.main()
            torch.cuda.empty_cache()
            if not all(0 < r["ms"] < math.inf for r in records):
                raise AssertionError(f"decomp {name}: a stage has no time")
            line["tools"][name] = {"seconds": time.perf_counter() - t0,
                                   "launches": launch_delta(before), "records": records}

    run_path(paths, "decomp", 0, go)
    line["launches"] = paths["decomp"]["launches"]
    emit(line)
    return line


# ---------------------------------------------------------------- phase 4c

COMPACT_ROWS = 10 * (1 << 20)  # the repository bench's st_10m (bench.py:2136-2197)
COMPACT_BATCH = 896
COMPACT_KW_FRAC = 0.75
COMPACT_BATCHES = 2           # timed; then one more, split
COMPACT_SAMPLE = 4            # oracle-checked queries a batch
COMPACT_SLAB = 1 << 20        # rows a check, kernel slice or scan slab holds
COMPACT_RESCORE_ROWS = 1 << 16  # random rows whose native rescore is held to numpy


def compact_exact_scan(dix, reqs, now) -> list:
    """The exact float64 scan of every row of a compact index for each
    request, as DTOs: ops/oracle.py's hybrid score over the rows that
    materialize_raw_rows defines (the native int8 rescore, which its loader
    holds bit-identical to numpy's materialize-then-rescore chain, and
    compact_rescore_check to numpy at this shape) plus the recency term, in
    slabs of rows; each query's top-k by score, created and seq,
    descending."""
    import numpy as np

    from omni_recall_tpu_torch.index.device_index import to_micros
    from omni_recall_tpu_torch.ops import native, oracle

    nq = len(reqs)
    q = np.stack([np.asarray(e, dtype=np.float32) for _, e, _ in reqs])
    qn = np.sum(q * q, axis=1, dtype=np.float64)
    terms = [oracle.query_terms(t) if t.strip() else [] for t, _, _ in reqs]
    flat = [t.encode("utf-8") for ts in terms for t in ts]
    term_off = np.zeros(len(flat) + 1, dtype=np.int64)
    np.cumsum([len(t) for t in flat], out=term_off[1:])
    q_term_off = np.zeros(nq + 1, dtype=np.int64)
    np.cumsum([len(ts) for ts in terms], out=q_term_off[1:])
    ks = [k for _, _, k in reqs]
    now_us = to_micros(now)
    kept: list[list] = [[] for _ in range(nq)]
    for lo in range(0, dix.n_rows, COMPACT_SLAB):
        rows = np.arange(lo, min(lo + COMPACT_SLAB, dix.n_rows), dtype=np.int64)
        m = rows.size
        partial = native.hybrid_rescore_int8(
            dix.emb8_host, dix.scale_host, dix.raw_norm_sq, dix._arena, dix.content_off,
            np.tile(rows, nq), np.repeat(np.arange(nq, dtype=np.int64), m), q, qn,
            b"".join(flat), term_off, q_term_off)
        if partial is None:
            raise AssertionError("the native int8 rescore is not available")
        age = np.maximum(0.0, ((now_us - dix.created_us[rows]).astype(np.float64) / 1e6)
                         / 86400.0)
        scores = partial.reshape(nq, m) + oracle.RECENCY_WEIGHT * np.exp(
            -age / oracle.RECENCY_HALF_LIFE_DAYS)
        for i in range(nq):
            kth = np.partition(scores[i], m - ks[i])[m - ks[i]]
            sel = np.nonzero(scores[i] >= kth)[0]  # ties at the kth stay
            kept[i].append((rows[sel], scores[i][sel]))
    out = []
    for i in range(nq):
        r = np.concatenate([x for x, _ in kept[i]])
        v = np.concatenate([y for _, y in kept[i]])
        order = np.lexsort((-dix.seqs[r], -dix.created_ts[r], -v))[: ks[i]]
        out.append([(dix.meta[int(x)].id, round(float(y), 4)) for x, y in zip(r[order], v[order])])
    return out


def compact_rescore_check(dix, sampled, now, seed: int) -> dict:
    """The native int8 rescore, which both the served compact path and
    compact_exact_scan score with, held bit for bit to plain numpy written
    from the definitions, for every sampled query: on its served top-k rows
    and on COMPACT_RESCORE_ROWS random rows of the store. The numpy chain
    is the rows materialize_raw_rows defines (fl32(int8 * scale)), their
    f32 products with the query summed in float64, the store's raw_norm_sq
    as the row's norm, and ops/oracle.py's keyword term on each row's
    content; with its recency term added, the served hits' exact scores
    must equal it too."""
    import numpy as np

    from omni_recall_tpu_torch.index.device_index import to_micros
    from omni_recall_tpu_torch.ops import native, oracle

    t = time.perf_counter()
    rng = np.random.default_rng(seed + 3000)
    slab = np.sort(rng.choice(dix.n_rows, COMPACT_RESCORE_ROWS, replace=False))
    slab_raw = dix.materialize_raw_rows(slab)

    def contents(rows):
        return [bytes(dix._arena[dix.content_off[r] : dix.content_off[r + 1]]).decode(
            "utf-8", errors="surrogatepass") for r in rows]

    slab_contents = contents(slab)
    now_us = to_micros(now)
    pairs = 0
    for (text, emb, _), hits in sampled:
        q = np.zeros(dix.dim, dtype=np.float32) if emb is None else np.asarray(
            emb, dtype=np.float32)
        qn = float(np.sum((q * q).astype(np.float64)))
        terms = oracle.query_terms(text) if text.strip() else []
        flat = [x.encode("utf-8") for x in terms]
        term_off = np.zeros(len(flat) + 1, dtype=np.int64)
        np.cumsum([len(x) for x in flat], out=term_off[1:])
        served = np.asarray([h.chunk.chunk_index for h in hits], dtype=np.int64)
        for rows, raw, texts in ((served, dix.materialize_raw_rows(served), contents(served)),
                                 (slab, slab_raw, slab_contents)):
            dot = np.sum(raw * q[None, :], axis=1, dtype=np.float64)
            ns = dix.raw_norm_sq[rows]
            ok = (ns > 0.0) & (qn > 0.0)
            cos = np.zeros(rows.size, dtype=np.float64)
            cos[ok] = dot[ok] / (np.sqrt(qn) * np.sqrt(ns[ok]))
            kw_of: dict[str, float] = {}
            kw = np.asarray([
                kw_of.setdefault(c, oracle.keyword_score_terms(terms, c)
                                 if terms and c.strip() else 0.0)
                for c in texts], dtype=np.float64)
            want = oracle.COSINE_WEIGHT * cos + oracle.KEYWORD_WEIGHT * kw
            got = native.hybrid_rescore_int8(
                dix.emb8_host, dix.scale_host, dix.raw_norm_sq, dix._arena, dix.content_off,
                rows, np.zeros(rows.size, dtype=np.int64), q[None, :], np.asarray([qn]),
                b"".join(flat), term_off, np.asarray([0, len(flat)], dtype=np.int64))
            if got is None:
                raise AssertionError("the native int8 rescore is not available")
            bad = np.nonzero(got.view(np.int64) != want.view(np.int64))[0]
            if bad.size:
                raise AssertionError(
                    f"query {text!r}: native int8 rescore of row {int(rows[bad[0]])} is "
                    f"{got[bad[0]]!r}, numpy {want[bad[0]]!r} ({bad.size} of {rows.size} "
                    "rows differ)")
            pairs += rows.size
            if rows is served:
                age = np.maximum(0.0, ((now_us - dix.created_us[rows]).astype(np.float64)
                                       / 1e6) / 86400.0)
                full = want + oracle.RECENCY_WEIGHT * np.exp(
                    -age / oracle.RECENCY_HALF_LIFE_DAYS)
                if [h.score for h in hits] != full.tolist():
                    raise AssertionError(f"query {text!r}: served scores "
                                         f"{[h.score for h in hits]} != numpy {full.tolist()}")
    return {"queries": len(sampled), "slab_rows": int(slab.size), "pairs": pairs,
            "seconds": time.perf_counter() - t}


def compact_plane_check(dix, n_clusters: int) -> dict:
    """Every device plane of the compact index against the host's columns,
    slab by slab on the card: the int8 rows against the host emb8 column,
    the bloom rows against the signature of each row's cluster (the table
    by the batch signature function, 64 clusters also by the Python
    one), scale
    against the host column, err against the derivation from the host
    rows' exact sums of squares, created against the host days."""
    import numpy as np
    import torch

    from omni_recall_tpu_torch.index import compact
    from omni_recall_tpu_torch.ops import hashing

    dev = dix.device_arrays()
    contents = compact.cluster_contents(n_clusters)
    table = hashing.chunk_signatures_batch(contents, dix.bloom_bits, dix.ngram, dix.bloom_hashes)
    for c in range(0, n_clusters, max(1, n_clusters // 64)):
        if not np.array_equal(table[c], hashing.chunk_signature(
                contents[c], dix.bloom_bits, dix.ngram, dix.bloom_hashes)):
            raise AssertionError(f"cluster {c}: batch and Python signatures differ")
    cuda = dev.emb.device
    differ: dict[str, list[int]] = {}
    t = time.perf_counter()
    for lo in range(0, dix.n_rows, COMPACT_SLAB):
        hi = min(lo + COMPACT_SLAB, dix.n_rows)
        cid, _ = compact.row_ids_np(lo, hi, n_clusters, 4096)
        rows = torch.from_numpy(dix.emb8_host[lo:hi]).to(cuda)
        s2 = rows.to(torch.int32).square().sum(dim=1).cpu().numpy().astype(np.int64)
        scale, err, _ = compact.derive_columns(s2)
        want = {"emb": rows, "bloom": table[cid], "scale": dix.scale_host[lo:hi], "err": err,
                "created": dix.created[lo:hi]}
        if not np.array_equal(scale, dix.scale_host[lo:hi]):
            differ.setdefault("scale_host", []).append(lo)
        for name, host in want.items():
            host = host if isinstance(host, torch.Tensor) else torch.from_numpy(
                np.ascontiguousarray(host)).to(cuda)
            if not bitwise(getattr(dev, name)[lo:hi], host):
                differ.setdefault(name, []).append(lo)
    if not bool(dev.valid.all()) or dev.valid.shape[0] != dix.n_rows:
        differ["valid"] = [0]
    if differ:
        raise AssertionError(f"compact device planes differ from the host columns at {differ}")
    return {"planes": ["emb", "bloom", "scale", "err", "created", "valid"], "parity": "bitwise",
            "slab_rows": COMPACT_SLAB, "check_s": time.perf_counter() - t}


def compact_kernel_lines(planes, seed: int) -> dict:
    """K1, K4 and K5 over the whole compact plane (N = 10 x 2^20, B = 896,
    W = 64; K1 at the serving layout (1024, t 2), K4 at the rescue layout
    (512, t 4), K5 at the keyword layout (1024, t 4)), each held bitwise to
    its plain version slab by slab: the plain version scans each 2^20-row
    slab (whose slices are the kernel's, indices shifted by the slab's first
    row) since at 10 x 2^20 rows it would hold scores of every row and
    query at once. Each line: the kernel's time on the whole plane beside
    its bound, the plain version's over the ten slabs (one run), and for K1
    the int8 product alone (``torch._int_mm`` over the ten slabs)."""
    import torch

    from omni_recall_tpu_torch.ops import scorer

    emb, bloom = planes.emb, planes.bloom
    (n, d), w, b, s = emb.shape, bloom.shape[1], COMPACT_BATCH, COMPACT_SLAB
    dev = emb.device
    g = torch.Generator(device=dev).manual_seed(seed + 17)

    def ri(lo, hi, shape, dtype):
        return torch.randint(lo, hi, shape, generator=g, device=dev).to(dtype)

    def rf(shape, scale=1.0, offset=0.0):
        return torch.rand(shape, generator=g, device=dev) * scale + offset

    q8 = ri(-127, 128, (b, d), torch.int8)
    add_row = rf((1, n), 0.1)
    add_row[0, rf((n,)) < 0.01] = -1e30  # tombstones
    scale_row = planes.scale.view(1, n)
    q_scale, q_bias = rf((b, 1), 1e-3, 1e-3), rf((b, 1), 0.01)
    # about 24 nonzero keyword weights a query, 1 to 8: the term stays
    # below its clamp at 1, so the keyword dot's value shows
    kw_w8 = torch.where(rf((b, 8 * w)) < 24 / (8 * w), ri(1, 9, (b, 8 * w), torch.int8),
                        torch.zeros((), dtype=torch.int8, device=dev))
    kw_b = rf((b, 1), 0.05)

    def coarse(fn, lo, hi, sub, t):
        return fn(emb[lo:hi], q8, add_row[:, lo:hi], scale_row[:, lo:hi], q_scale, q_bias,
                  t=t, sub=sub)

    def fused(fn, lo, hi, sub, t):
        return fn(emb[lo:hi], bloom[lo:hi], q8, kw_w8, kw_b, add_row[:, lo:hi],
                  scale_row[:, lo:hi], q_scale, q_bias, t=t, sub=sub)

    def kw(fn, lo, hi, sub, t):
        return fn(bloom[lo:hi], kw_w8, kw_b, add_row[:, lo:hi], t=t, sub=sub)

    # name: (call, kernel, plain version, layout (sub, t), its TPU kernel's line, bound)
    scans = {
        "coarse_scan": (coarse, scorer.block_topt_int8_coarse,
                        scorer.block_topt_int8_coarse_plain, (1024, 2), 628,
                        coarse_bound(n, b, d, 4, b * (n // 1024) * 3 * 8)),
        "fused_scan": (fused, scorer.block_topt_int8, scorer.block_topt_int8_plain, (512, 4), 824,
                       bound_ms(n * d + n * w + b * d + b * 8 * w + 8 * n + 12 * b
                                + b * (n // 512) * 5 * 8, 2.0 * n * b * (d + 8 * w),
                                INT8_OPS_PER_S)),
        "kw_scan": (kw, scorer.block_topt_kw_only, scorer.block_topt_kw_only_plain, (1024, 4), 519,
                    bound_ms(n * w + b * 8 * w + 4 * n + 4 * b + b * (n // 1024) * 5 * 8,
                             2.0 * n * b * 8 * w, INT8_OPS_PER_S)),
    }

    def int_mm_slabs():
        for lo in range(0, n, s):
            torch._int_mm(q8, emb[lo:lo + s].t())

    library = {"coarse_scan": (
        time_ms(int_mm_slabs, device_only=True),
        f"torch._int_mm(q8, emb8[slab].t()) over the {n // s} slabs of {s} rows: the int8 "
        "cosine product alone")}
    torch.cuda.empty_cache()
    lines = {}
    for name, (call, kern, plain, layout, line_no, (bms, by)) in scans.items():
        sub = layout[0]
        kv, ki = call(kern, 0, n, *layout)
        per = s // sub  # the kernel's slices of one slab
        ok, err, plain_s = True, 0.0, 0.0
        for j, lo in enumerate(range(0, n, s)):
            torch.cuda.synchronize()
            t = time.perf_counter()
            pv, pi = call(plain, lo, lo + s, *layout)
            torch.cuda.synchronize()
            plain_s += time.perf_counter() - t
            pi = torch.where(pi >= 0, pi + lo, pi)
            part = slice(j * per, (j + 1) * per)
            ok = ok and bitwise(kv[:, part].contiguous(), pv) and bitwise(
                ki[:, part].contiguous(), pi)
            err = max(err, float((kv[:, part] - pv).abs().max()))
            del pv, pi
        del kv, ki
        lines[name] = dict(
            name=f"{name}[compact]", replaces=f"omni_recall_tpu/ops/pallas_scorer.py:{line_no}",
            shape=[b, n, d], bloom_bits=8 * w, layout=list(layout),
            parity=bitwise_parity(ok), parity_by=f"slabs of {s} rows", max_abs_err=err,
            ms=time_ms(lambda: call(kern, 0, n, *layout), device_only=True),  # noqa: B023
            plain_ms=plain_s * 1e3, plain_runs=1, bound_ms=bms, bound_by=by,
            library_ms=library.get(name, (None,))[0], library=library.get(name, (None, "none"))[1])
        emit({"phase": "kernel", **lines[name]})
        if not ok:
            raise AssertionError(f"{name}[compact]: kernel disagrees with its plain version")
        torch.cuda.empty_cache()
    return lines


def compact_phase(seed: int, paths: dict) -> dict:
    """The ``compact`` path: the compact 10M store of the repository bench
    (n = 10 x 2^20, d 768, B 896, kw_frac 0.75, bench.py st_10m) built by
    ``build_compact_engine`` (host columns by the slab loop, device planes
    filled on the card), every device plane held bitwise to the host
    columns, then batches served with a sample of every batch DTO-identical
    to the exact float64 scan of every row (``compact_exact_scan``) and the
    native rescore both score with held bit for bit to plain numpy
    (``compact_rescore_check``); K1, K4 and K5 at this shape
    (``compact_kernel_lines``)."""
    import gc

    import torch

    from omni_recall_tpu_torch.index import compact

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    n, b = COMPACT_ROWS, COMPACT_BATCH
    ticks: list[float] = []
    t0 = time.perf_counter()
    engine, make_requests, now, n_clusters = compact.build_compact_engine(
        n, DIM, checkpoint=lambda: ticks.append(time.perf_counter()))
    torch.cuda.synchronize()
    t_end = time.perf_counter()
    host_ticks = n // (1 << 19) + 1  # one a host slab, one after the derived columns
    dix = engine.device_index
    line = {"phase": "compact", "rows": n, "dim": DIM, "bloom_bits": dix.bloom_bits,
            "batch": b, "kw_frac": COMPACT_KW_FRAC, "n_clusters": n_clusters,
            "config": "build_compact_engine: pallas int8, coarse (1024, 2), direct selection, "
                      "select_t_out 32, candidate_m 128, no refine, no DD",
            "reduced": "none: 10 x 2^20 rows as bench.py st_10m",
            "host_build_s": ticks[host_ticks - 1] - t0,
            "device_fill_s": t_end - ticks[host_ticks - 1],
            "host_store_bytes": int(
                dix.emb8_host.nbytes + dix.scale_host.nbytes + dix.raw_norm_sq.nbytes
                + dix.created_us.nbytes + dix.created_ts.nbytes + dix.created.nbytes
                + dix.seqs.nbytes + len(dix._arena) + dix.content_off.nbytes
                + dix.valid.nbytes),
            "device_plane_gib": {k: round(getattr(dix.device_arrays(), k).numel()
                                          * getattr(dix.device_arrays(), k).element_size()
                                          / 2**30, 3) for k in ("emb", "bloom")}}
    line["plane_check"] = compact_plane_check(dix, n_clusters)

    def serve():
        engine.search_batch(make_requests(seed + 2000, b, COMPACT_KW_FRAC), now=now)  # warm-up
        batches = [make_requests(seed + 2001 + i, b, COMPACT_KW_FRAC)
                   for i in range(COMPACT_BATCHES)]
        lat, out = [], []
        for reqs in batches:
            t = time.perf_counter()
            out.append(engine.search_batch(reqs, now=now))
            lat.append(time.perf_counter() - t)
        # where one more batch's time goes
        reqs = make_requests(seed + 2100, b, COMPACT_KW_FRAC)
        res, _, line["breakdown"] = split_batch(engine, reqs, now)
        out.append(res)
        batches.append(reqs)
        return batches, out, lat

    batches, out, lat = run_path(paths, "compact", COMPACT_BATCHES + 2, serve, engine.stats)
    rec = paths["compact"]
    stats = rec["stats"]
    line.update(
        certified_qps=COMPACT_BATCHES * b / sum(lat), p50_batch_ms=statistics.median(lat) * 1e3,
        batch_ms=[x * 1e3 for x in lat],
        launches_per_batch={k: rec["launches"][k] / rec["batches"]
                            for k in ("coarse_scan", "fused_scan", "kw_scan")},
        # the split batch bypasses search_batch's query count: every
        # served query is a batch's
        resolved_share=stats.get("coarse_resolved_total", 0) / (rec["batches"] * b),
        host_fallbacks=stats.get("host_fallbacks_total", 0), stats=stats)
    if any(len(hits) != 10 for res in out for hits in res):
        raise AssertionError("a compact query returned fewer than 10 hits")
    t = time.perf_counter()
    sampled = [(reqs[i], res[i]) for reqs, res in zip(batches, out) for i in range(COMPACT_SAMPLE)]
    want = compact_exact_scan(dix, [r for r, _ in sampled], now)
    for ((text, _, _), hits), w in zip(sampled, want):
        if dto(hits) != w:
            raise AssertionError(f"compact query {text!r}: {dto(hits)} != exact scan {w}")
    line.update(oracle_checked=len(sampled), oracle_per_batch=COMPACT_SAMPLE,
                exact_scan_s=time.perf_counter() - t)
    line["rescore_check"] = compact_rescore_check(dix, sampled, now, seed)
    line["kernels"] = compact_kernel_lines(dix.device_arrays(), seed)
    # K1's layouts over these planes (omni_recall_tpu_torch/tools/sweep_10m.py)
    from omni_recall_tpu_torch.index.device_index import to_days
    from omni_recall_tpu_torch.tools import sweep_10m

    line["sweep_10m"] = run_path(paths, "sweep_10m", len(sweep_10m.DEFAULT_CONFIGS), lambda: (
        sweep_10m.sweep(dix.device_arrays(), float(to_days(now)))))
    failed = [r for r in line["sweep_10m"] if "failed" in r]
    if failed:
        raise AssertionError(f"sweep_10m: configurations failed: {failed}")
    emit({"phase": "sweep_10m", "gpu": nvidia_smi(), "records": line["sweep_10m"]})
    line["max_memory_allocated_gib"] = torch.cuda.max_memory_allocated() / 2**30
    line["path"] = paths["compact"]
    emit({k: v for k, v in line.items() if k not in ("kernels", "sweep_10m")})
    del engine, dix, batches, out, sampled
    gc.collect()
    torch.cuda.empty_cache()
    return line


# ---------------------------------------------------------------- main


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--parent", help="root of an earlier checkout (a git archive of the "
                        "parent commit): its csrc/dd_rows.cu and csrc/refine.cu (K2, K3) are "
                        "built and timed beside this checkout's, and held to them")
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this check needs an "
              "NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from omni_recall_tpu_torch.ops import cuda

    smi = nvidia_smi()
    nvcc = subprocess.run([cuda.nvcc_path(), "--version"], check=True,
                          capture_output=True, text=True).stdout.strip().splitlines()[-1]
    parent = ParentBuild(args.parent) if args.parent else None
    build_s = cuda.build_all(force=True)
    if parent is not None:
        parent.load()
    emit({"phase": "env", "torch": torch.__version__, "cuda": torch.version.cuda,
          "nvcc": nvcc, "gpu": smi, "kernel_build_s": build_s,
          "device": torch.cuda.get_device_name(0)})

    t_start = time.perf_counter()
    k = kernel_phase(args.seed, parent)

    paths: dict = {}
    clock = [("kernel", time.perf_counter() - t_start)]

    def timed(name, fn, *a):
        t = time.perf_counter()
        out = fn(*a)
        clock.append((name, time.perf_counter() - t))
        print(json.dumps({"phase_seconds": dict([clock[-1]])}), flush=True)
        return out

    profile = timed("profile", profile_path, paths)
    stages = timed("probe_serve", probe_serve_path, paths)
    timed("server", run_path, paths, "server", len(QUERIES) + 2, server_phase)
    # the localq path's exact host scans (~0.36 s a query at 2^20 rows) and
    # the local models' paths grew the run past 450 s: the embedding path
    # serves 3 timed batches here, not 4, the refine-select and the bf16 /
    # f32 / reference-default paths 2, not 3, and the compact path 2
    # (COMPACT_BATCHES), each batch still with its oracle sample
    trace: dict = {}
    timed("serve", lambda: serve_phase(args.seed, paths, 3, 2, 8, 2, trace=trace))
    timed("snapshot", snapshot_phase, args.seed, paths)
    timed("localq", localq_phase, args.seed, paths)
    timed("train", train_phase, args.seed, paths)
    timed("chat_local", chat_local_phase, paths)
    timed("probe_localq", probe_localq_path, paths)
    timed("bench_ingest", bench_ingest_path, paths)
    timed("eval", eval_phase, paths, trace)
    timed("decomp", decomp_path, paths)
    compact = timed("compact", compact_phase, args.seed, paths)
    emit({"phase": "clock", "seconds": dict(clock),
          "total_s": time.perf_counter() - t_start})

    def entry(name, route_key, source, line, extra=None):
        home = paths[HOME_PATH[route_key]]
        return {"name": name, "route": "cuda", "source": source,
                "replaces": line["replaces"], "launches": home["launches"][route_key],
                "path": HOME_PATH[route_key],
                "launches_per_batch": home["launches"][route_key] / home["batches"],
                "launches_by_path": {p: v["launches"][route_key] for p, v in paths.items()},
                "max_abs_err": line["max_abs_err"], "ms": line["ms"],
                "plain_ms": line["plain_ms"], "bound_ms": line["bound_ms"],
                "bound_by": line["bound_by"], "library_ms": line["library_ms"],
                "parity": line["parity"], **(extra or {})}

    def probe_entry(name, route_key, source, replaces, lines, top, records, of):
        """A probe's entry: the numbers of its sub-entry ``top``, then its
        sub-entries (one per variant or layout) with their serving-shape
        lines, their launches on the profiling path and the tool's sweep
        beside its bounds."""
        subs = {}
        for sub, line in lines.items():
            mine = [r for r in records if of(r) == sub]
            subs[sub] = {
                "name": line["name"], "route": "cuda", "source": source,
                "replaces": line["replaces"], "launches": sum(r["launches"] for r in mine),
                **{key: v for key, v in line.items()
                   if key not in ("name", "replaces")},
                "tool_sweep": [{key: r[key] for key in r if key != "launches"} for r in mine],
            }
        return entry(name, route_key, source, lines[top], {
            "replaces": replaces, "sub_entries": subs, "plain_runs": lines[top]["plain_runs"],
            **{key: lines[top][key] for key in PARENT_KEYS if key in lines[top]}})

    def t3_entry(lines, stages):
        """T3's entry: its line at the tool's shape, the select shape's line,
        and the stage decomposition's times."""
        top = lines["tool"]
        keep = ("shape", "qg", "ct", "ms", "plain_ms", "bound_ms", "bound_by", "k3_ms",
                "k3_wrapper_ms", "gather_ms", "quantize_ms", "gather_quantize_t3_ms",
                "max_abs_err")
        return entry("T3 probe_serve", "probe_serve", "omni_recall_tpu_torch/csrc/refine.cu",
                     top, {
                         **{key: top[key] for key in keep}, "plain_runs": top["plain_runs"],
                         "k3_diagonal": "bitwise" if all(
                             x["k3_diagonal_bitwise"] for x in lines.values()) else "FAILED",
                         "select_shape": {key: lines["select"][key] for key in keep},
                         "stages_ms": {name: r["ms"] for name, r in stages["stages"].items()},
                         "sum_tool_design_ms": stages["sum_tool_design_ms"],
                         "sum_port_design_ms": stages["sum_port_design_ms"]})

    int8_src = "omni_recall_tpu_torch/csrc/int8_scan.cu"
    fp_src = "omni_recall_tpu_torch/csrc/fp_scan.cu"
    rescue = k["refine_rescue"]
    ab_keys = ("library", *PARENT_KEYS)

    def int8_entry(name, route_key, line, keys=(), extra=None):
        return entry(name, route_key, int8_src, line,
                     {**{key: line[key] for key in ab_keys + keys if key in line},
                      **(extra or {})})

    def compact_extra(route_key):
        """A kernel's line at the compact shape, with its launches there."""
        return {"compact": {**compact["kernels"][route_key],
                            "launches": paths["compact"]["launches"][route_key],
                            "launches_per_batch": compact["launches_per_batch"][route_key]}}

    kernels = [
        int8_entry("K1 coarse_scan", "coarse_scan", k["coarse_packed"],
                   extra=compact_extra("coarse_scan")),
        int8_entry("K7a coarse_scan pair mode", "coarse_pair", k["coarse_two_reduce"]),
        entry("K2 dd_rows", "dd_rows", "omni_recall_tpu_torch/csrc/dd_rows.cu", k["dd"],
              {**{key: k["dd"][key] for key in ("sabs_rel_err", "layout", "l2_rows_ms",
                                                "gather_ms", *PARENT_KEYS) if key in k["dd"]},
               "entries": ["omni_dd_rows (by index)", "omni_dd_rows_gathered"],
               # the sharded path reaches K2 only through its gathered entry
               "gathered_entry": {**{key: k["dd_gathered"][key] for key in (
                   "name", "entry", "shape", "parity", "by_index_bitwise", "sabs_rel_err",
                   "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
                   "launches": paths["sharded"]["launches"]["dd_rows"],
                   "path": "sharded"}}),
        entry("K3 refine", "refine", "omni_recall_tpu_torch/csrc/refine.cu",
              k["refine_select"], {
                  **{key: k["refine_select"][key] for key in (
                      "shape", "wrapper_ms", "strided_bitwise", "l2_rows_ms", "gather_ms",
                      *PARENT_KEYS) if key in k["refine_select"]},
                  "rescue_shape": {key: rescue[key] for key in (
                      "shape", "ms", "wrapper_ms", "plain_ms", "bound_ms", "bound_by",
                      "max_abs_err", "strided_bitwise", "l2_rows_ms", "gather_ms",
                      *PARENT_KEYS) if key in rescue},
                  "recency_check": k["refine_recency"]}),
        int8_entry("K4 fused_scan", "fused_scan", k["fused"], extra=compact_extra("fused_scan")),
        int8_entry("K5 kw_scan", "kw_scan", k["kw"], ("query_tile", "sub512"),
                   extra=compact_extra("kw_scan")),
        entry("K6 fp_scan", "fp_scan", fp_src, k["fp_bf16"], {
            "storage": "bf16", "plain_runs": 1,
            **{key: k["fp_bf16"][key] for key in FP_RULE_KEYS},
            "f32_storage": {key: k["fp_f32"][key] for key in (
                "ms", "plain_ms", "bound_ms", "bound_by", "max_abs_err", "parity",
                *FP_RULE_KEYS)},
            "launches_per_batch_f32": paths["f32_batches"]["launches"]["fp_scan"]
            / paths["f32_batches"]["batches"]}),
        probe_entry("T1 profile_kernel", "profile_kernel", fp_src,
                    "tools/profile_kernel.py:26", k["t1"], "full",
                    profile["profile_kernel"], lambda r: r["variant"]),
        probe_entry("T5 profile_bloomT", "profile_bloomT", int8_src,
                    "tools/profile_bloomT.py:39", k["t5"], "row", profile["profile_bloomT"],
                    lambda r: "transposed" if r["transposed"] else "row"),
        # T2's sweep at sub 512 goes with its line at the tool's layout, at
        # sub 1024 with the serving layout's (same slice width, query tile)
        probe_entry("T2 probe_pipe", "probe_pipe", int8_src, "tools/probe_pipe.py:85",
                    k["t2"], "serving", profile["probe_pipe"],
                    lambda r: "tool" if r["sub"] == T2_LAYOUTS["tool"][0] else "serving"),
        probe_entry("T4 probe_keys_emit", "probe_keys_emit", int8_src,
                    "tools/probe_keys_emit.py:123", k["t4"], "pair",
                    profile["probe_keys_emit"], lambda r: r["emit"]),
        t3_entry(k["refine_t3"], stages),
    ]
    emit({"kernels": kernels})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
