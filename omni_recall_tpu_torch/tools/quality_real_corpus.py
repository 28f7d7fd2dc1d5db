"""Run the REAL-corpus retrieval quality campaign (eval/real_corpus.py):
recall@10 for the keyword-only, hash, untrained and corpus-fine-tuned
embedding providers on the Python-stdlib-documentation corpus, ingested
through the normal upload path. Prints one JSON object; the README records
the numbers.

Counterpart of the repository's ``tools/quality_real_corpus.py``. Run:
``python -m omni_recall_tpu_torch.tools.quality_real_corpus [--steps N]
[--seed S] [--device cpu]`` (the fine-tune's steps, default 300; CUDA
unless the CPU is asked).
"""

from __future__ import annotations

import argparse
import json


def main(argv=None) -> dict[str, float]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    from omni_recall_tpu_torch.eval.real_corpus import evaluate_real_corpus

    results = evaluate_real_corpus(steps=args.steps, seed=args.seed, device=args.device)
    print(json.dumps(results))
    return results


if __name__ == "__main__":
    main()
