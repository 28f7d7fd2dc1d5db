"""Registers and spills of every kernel the CUDA sources build, as ptxas
reports them, optionally beside another checkout's.

``python -m omni_recall_tpu_torch.tools.ptxas_report [--against DIR]``
compiles each source of ``omni_recall_tpu_torch/csrc`` with the build's own
flags plus ``-Xptxas -v`` (one ``nvcc`` for each source, all started
together, into the git-ignored build directory) and prints one JSON line a
source: each kernel instantiation (its mangled name, the anonymous
namespace's hashes dropped) with its registers and spill bytes.
``--against DIR`` also compiles the sources of the checkout at DIR (every
``*.cu`` either checkout has, so a source one of them retired is listed
too) and lists the instantiations whose numbers differ and those found on
one side only (the other checkout's with their numbers).
Each line also counts the source's SASS opcodes of interest
(``sass_counts``: ``HGMMA`` and ``IGMMA``, the tensor-core warpgroup
products in bf16 and in int8, ``IMMA``, the warp-level int8 product of
``mma.sync``, and ``UTMALDG``, the TMA loads), in all and
for each kernel of this checkout (``sass_by_kernel``), read with
``cuobjdump -sass``. It needs ``nvcc``; it runs no kernel.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
from pathlib import Path

from omni_recall_tpu_torch.ops import cuda

_ENTRY = re.compile(r"Compiling entry function '([^']+)'")
_SPILL = re.compile(r"(\d+) bytes spill stores, (\d+) bytes spill loads")
_REGS = re.compile(r"Used (\d+) registers")
# the anonymous namespace's name, and the hash nvcc appends to the source's
# name inside it, both differ between checkouts of the same source
_ANON = re.compile(r"_GLOBAL__N__[0-9a-f]+_|(?<=_cu_)[0-9a-f]{8}")


def parse(log: str) -> dict[str, dict[str, int]]:
    """ptxas -v output -> {kernel: {registers, spill_stores, spill_loads}}."""
    kernels: dict[str, dict[str, int]] = {}
    name = None
    for line in log.splitlines():
        if m := _ENTRY.search(line):
            # drop the hashes of the anonymous namespace, so two checkouts'
            # instantiations compare by name
            name = _ANON.sub("", m.group(1))
            kernels[name] = {}
        elif name and (m := _SPILL.search(line)):
            kernels[name].update(spill_stores=int(m.group(1)), spill_loads=int(m.group(2)))
        elif name and (m := _REGS.search(line)):
            kernels[name]["registers"] = int(m.group(1))
    return kernels


SASS_OPCODES = ("HGMMA", "IGMMA", "IMMA", "UTMALDG")


_FUNCTION = re.compile(r"^\s*Function : (\S+)", re.M)


def _sass(lib: Path) -> str:
    cuobjdump = Path(cuda.nvcc_path()).with_name("cuobjdump")
    return subprocess.run([str(cuobjdump), "-sass", str(lib)], check=True,
                          capture_output=True, text=True).stdout


def _count(sass: str) -> dict[str, int]:
    return {op: len(re.findall(rf"\b{op}\b", sass)) for op in SASS_OPCODES}


def sass_counts(lib: Path) -> dict[str, int]:
    """How many instructions of each of ``SASS_OPCODES`` a built library's
    SASS holds (``cuobjdump -sass``, beside nvcc)."""
    return _count(_sass(lib))


def sass_counts_by_function(lib: Path) -> dict[str, dict[str, int]]:
    """``sass_counts`` for each kernel of the library, by mangled name (the
    anonymous namespace's hashes dropped, as in ``parse``)."""
    sass = _sass(lib)
    heads = list(_FUNCTION.finditer(sass))
    return {_ANON.sub("", m.group(1)): _count(sass[m.end():nxt.start() if nxt else len(sass)])
            for m, nxt in zip(heads, heads[1:] + [None])}


def sources(csrc_dirs: dict[str, Path]) -> list[str]:
    """Every ``*.cu`` of the csrc directories, by name."""
    return sorted({p.name for csrc in csrc_dirs.values() for p in csrc.glob("*.cu")})


def report(csrc_dirs: dict[str, Path]) -> dict[tuple[str, str], dict]:
    """Compile every source of each csrc directory (all at once) and parse
    ptxas's report: {(label, source): kernels}."""
    out_dir = cuda.BUILD_DIR / "ptxas"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for label, csrc in csrc_dirs.items():
        for src in sources(csrc_dirs):
            if not (csrc / src).is_file():  # a source one checkout does not have
                continue
            lib = out_dir / f"{label}_{Path(src).stem}.so"
            cmd = [cuda.nvcc_path(), *cuda.NVCC_FLAGS, "-Xptxas", "-v", "-o", str(lib),
                   str(csrc / src)]
            procs[(label, src)] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                   stderr=subprocess.STDOUT, text=True)
    results = {}
    for key, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {key}:\n{log}")
        results[key] = parse(log)
    return results


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--against", type=Path, help="another checkout's root directory")
    args = parser.parse_args()
    dirs = {"this": cuda.CSRC}
    if args.against:
        dirs["against"] = args.against / "omni_recall_tpu_torch" / "csrc"
    results = report(dirs)
    for src in sources(dirs):
        mine = results.get(("this", src), {})
        line = {"source": src, "kernels": mine}
        if ("this", src) in results:
            lib = cuda.BUILD_DIR / "ptxas" / f"this_{Path(src).stem}.so"
            line["sass_counts"] = sass_counts(lib)
            line["sass_by_kernel"] = sass_counts_by_function(lib)
        if args.against:
            theirs = results.get(("against", src), {})
            line["changed"] = {k: {"this": mine[k], "against": theirs[k]}
                               for k in mine.keys() & theirs.keys() if mine[k] != theirs[k]}
            line["only_this"] = sorted(mine.keys() - theirs.keys())
            line["only_against"] = {k: theirs[k] for k in sorted(theirs.keys() - mine.keys())}
        print(json.dumps(line), flush=True)


if __name__ == "__main__":
    main()
