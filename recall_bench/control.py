"""The control of the comparison that decides ``correct``: the plain
reference put in the program's place and computed in float32, the precision
below the configuration's f64 cosine. For each seed it builds the cell's
corpus and request pool as a run does, draws the run's sample, serves the
sample with ``Reference.control_top_k`` and holds those answers to the f64
reference with the run's own numbers and limits. Every seed has to come
out not correct.

    python3 -m recall_bench.control --workload <cell> --seeds <n>[,<n>...]

Prints one JSON line a seed. It needs no card: the program does not run.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from recall_bench import check, generator
from recall_bench import corpus as corpus_mod
from recall_bench.load import Answers
from recall_bench.reference import Reference


def control(cell, seed: int) -> dict:
    t = cell.traffic
    corpus = corpus_mod.make_corpus(cell.config["corpus"], seed)
    pool = generator.make_requests(t, corpus, seed)
    ref = Reference(corpus)
    sample = check.draw_sample(seed, list(range(len(pool))), t["sample"])
    reqs = [(pool[q][0], pool[q][1]) for q in sample]
    expected = dict(zip(sample, ref.top_k(reqs, t["top_k"])))
    answers = Answers(t["top_k"])
    for q, (rows, scores) in zip(sample, ref.control_top_k(reqs, t["top_k"])):
        answers.add(q, 0.0, 0.0, rows, scores, None)
    cols = answers.columns()
    values = {"row_gap": check.row_gap(ref, [(r[0], r[1]) for r in pool], cols, t["top_k"]),
              "rank_gap": check.rank_gap(expected, cols, t["top_k"]),
              "unanswered": 0.0}
    correct, checks = check.judge(values, cell.limits)
    return {"seed": seed, "correct": correct, "checks": checks}


def main(argv=None) -> int:
    from recall_bench.run import load_cell

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    args = ap.parse_args(argv)
    cell = load_cell(Path.cwd(), args.workload)
    for s in args.seeds.split(","):
        print(json.dumps(control(cell, int(s))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
