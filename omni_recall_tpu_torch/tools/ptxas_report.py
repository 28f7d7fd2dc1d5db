"""Registers and spills of every kernel the CUDA sources build, as ptxas
reports them, optionally beside another checkout's.

``python -m omni_recall_tpu_torch.tools.ptxas_report [--against DIR]``
compiles each source of ``omni_recall_tpu_torch/csrc`` with the build's own
flags plus ``-Xptxas -v`` (one ``nvcc`` for each source, all started
together, into the git-ignored build directory) and prints one JSON line a
source: each kernel instantiation (its mangled name, the anonymous
namespace's path hash dropped) with its registers and spill bytes.
``--against DIR`` also compiles the sources of the checkout at DIR and lists
the instantiations whose numbers differ and those found on one side only.
It needs ``nvcc``; it runs no kernel.
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
_ANON = re.compile(r"_GLOBAL__N__[0-9a-f]+_")


def parse(log: str) -> dict[str, dict[str, int]]:
    """ptxas -v output -> {kernel: {registers, spill_stores, spill_loads}}."""
    kernels: dict[str, dict[str, int]] = {}
    name = None
    for line in log.splitlines():
        if m := _ENTRY.search(line):
            # the anonymous namespace's name hashes the file's path: drop it,
            # so two checkouts' instantiations compare by name
            name = _ANON.sub("", m.group(1))
            kernels[name] = {}
        elif name and (m := _SPILL.search(line)):
            kernels[name].update(spill_stores=int(m.group(1)), spill_loads=int(m.group(2)))
        elif name and (m := _REGS.search(line)):
            kernels[name]["registers"] = int(m.group(1))
    return kernels


def report(csrc_dirs: dict[str, Path]) -> dict[tuple[str, str], dict]:
    """Compile every source of each csrc directory (all at once) and parse
    ptxas's report: {(label, source): kernels}."""
    out_dir = cuda.BUILD_DIR / "ptxas"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for label, csrc in csrc_dirs.items():
        for src in cuda.SOURCES.values():
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
    for src in cuda.SOURCES.values():
        mine = results[("this", src)]
        line = {"source": src, "kernels": mine}
        if args.against:
            theirs = results[("against", src)]
            line["changed"] = {k: {"this": mine[k], "against": theirs[k]}
                               for k in mine.keys() & theirs.keys() if mine[k] != theirs[k]}
            line["only_this"] = sorted(mine.keys() - theirs.keys())
            line["only_against"] = sorted(theirs.keys() - mine.keys())
        print(json.dumps(line), flush=True)


if __name__ == "__main__":
    main()
