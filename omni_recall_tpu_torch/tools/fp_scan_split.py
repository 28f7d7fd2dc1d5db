"""Where the CUDA-core K6 spent its time: its body timed with parts removed.

The first CUDA K6 (``csrc/fp_scan.cu`` before its dots moved to the tensor
cores) summed each term on the CUDA cores with two f32 instructions, staged
rows, queries and bloom bits element by element with runtime divisions,
loaded each chunk between two barriers with one buffer, and took some 5x
the time its instruction count allows. ncu does not run on the card's
machine, so this tool splits that time by building the kernel from an
earlier checkout (``--old DIR``: the repository's root at a commit whose
``csrc/fp_scan.cu`` still holds the CUDA-core kernel) in four forms, and
times each at the serving shape (N = 2^20, d = 768, W = 128, B = 448, bf16
rows, sub 512, t 4):

- ``full``: as it was;
- ``no_staging``: the four shared-memory staging loops removed (the dots
  read whatever the buffers hold);
- ``no_dot``: the two chunk dots removed (staging and extraction only);
- ``no_extract``: the extraction removed.

The edits are textual and each must match the old source as many times as
stated. Only times are kept: the cut forms compute nothing meaningful. The
current kernel (``ops/scorer.py block_topt``) is timed beside them on the
same inputs. Prints one JSON line.

``python -m omni_recall_tpu_torch.tools.fp_scan_split --old DIR`` (needs
nvcc and the card).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
from pathlib import Path

import torch

from omni_recall_tpu_torch.ops import cuda, scorer
from omni_recall_tpu_torch.tools import median_ms

N, D, BITS, B, SUB, T = 1 << 20, 768, 1024, 448, 512, 4

# variant -> [(pattern, replacement, matches)]
_STAGING = re.compile(
    r"      for \(int i = tid; i < (?:ROWS|QT) \* kc; i \+= kThreads\) \{\n(?:.*\n)*?      \}\n")
_DOT = re.compile(r"      chunk_dot<QPT>\(tile, qs, kc, lane, warp, acc_[ck]\);\n")
_EXTRACT = re.compile(r"      omni::extract_query\(sc \+ ql \* R, R, a\.sub,[^;]*;\n")
EDITS = {
    "full": [],
    "no_staging": [(_STAGING, "", 4)],
    "no_dot": [(_DOT, "", 2)],
    "no_extract": [(_EXTRACT, "", 1)],
}


def variant_source(src: str, variant: str) -> str:
    for pattern, repl, count in EDITS[variant]:
        src, n = pattern.subn(repl, src)
        if n != count:
            raise ValueError(f"{variant}: {pattern.pattern!r} matched {n} times, expected {count}")
    return src


def build(old_csrc: Path) -> dict[str, ctypes.CDLL]:
    """Compile the four forms (one nvcc each, all at once) and load them."""
    src = (old_csrc / "fp_scan.cu").read_text()
    out = cuda.BUILD_DIR / "fp_scan_split"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for variant in EDITS:
        cu = out / f"{variant}.cu"
        cu.write_text(variant_source(src, variant))
        cmd = [cuda.nvcc_path(), *cuda.NVCC_FLAGS, "-I", str(old_csrc), "-o",
               str(out / f"lib{variant}.so"), str(cu)]
        procs[variant] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                          text=True)
    libs = {}
    for variant, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {variant}:\n{log}")
        lib = ctypes.CDLL(str(out / f"lib{variant}.so"))
        fn = lib.omni_fp_scan_topt
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
        libs[variant] = lib
    return libs


def main(old: Path, runs: int = 3) -> dict:
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    w = BITS // 8
    emb = torch.randn((N, D), generator=g, device=dev).to(torch.bfloat16)
    bloom = torch.randint(0, 256, (N, w), generator=g, device=dev).to(torch.uint8)
    q = torch.randn((B, D), generator=g, device=dev)
    kw = torch.where(torch.rand((B, 8 * w), generator=g, device=dev) < 0.03,
                     torch.rand((B, 8 * w), generator=g, device=dev) * 0.1,
                     torch.zeros((), device=dev))
    kw_b = torch.rand((B, 1), generator=g, device=dev) * 0.05
    add_row = torch.rand((1, N), generator=g, device=dev) * 0.1
    t1 = T + 1
    vals = torch.empty((B, N // SUB, t1), device=dev)
    idxs = torch.empty((B, N // SUB, t1), dtype=torch.int32, device=dev)
    libs = build(old / "omni_recall_tpu_torch" / "csrc")
    ms = {}
    for variant, lib in libs.items():
        def launch(lib=lib, variant=variant):
            rc = lib.omni_fp_scan_topt(
                emb.data_ptr(), bloom.data_ptr(), q.data_ptr(), kw.data_ptr(), kw_b.data_ptr(),
                add_row.data_ptr(), vals.data_ptr(), idxs.data_ptr(), N, D, w, B, SUB, t1,
                int(scorer._packed_mode(SUB, t1)), 1, cuda.stream_ptr(dev))
            if rc:
                raise RuntimeError(f"{variant}: launch failed ({rc})")
        ms[variant] = median_ms(launch, dev, runs)
    ms["wgmma_kernel"] = median_ms(
        lambda: scorer.block_topt(emb, bloom, q, kw, kw_b, add_row, t=T, sub=SUB), dev, runs)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    line = {"tool": "fp_scan_split", "gpu": smi, "shape": [B, N, D], "bits": BITS,
            "layout": [SUB, T], "runs": runs, "ms": ms}
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--old", type=Path, required=True,
                        help="root of a checkout whose csrc/fp_scan.cu holds the CUDA-core K6")
    args = parser.parse_args()
    main(args.old)
