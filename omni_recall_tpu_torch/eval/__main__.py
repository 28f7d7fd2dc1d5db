"""Eval CLI: ``python -m omni_recall_tpu_torch.eval --cases cases.json ...``.

``--in-process`` boots the port's app on the card (``--device cuda``, the
default) or, when asked, on the CPU (``--device cpu``: the plain PyTorch
versions of the kernels). Without a card and without ``--device cpu`` it
exits non-zero; there is no silent CPU fallback."""

from __future__ import annotations

import argparse
import json
import sys

from omni_recall_tpu_torch.eval.harness import EvalHarness, generate_cases, load_cases


def main() -> int:
    parser = argparse.ArgumentParser(description="Omni Recall eval harness")
    parser.add_argument("--cases", help="JSON cases file [{question, expectedFile, topK}]")
    parser.add_argument("--generate", action="store_true",
                        help="auto-generate cases from uploaded documents")
    parser.add_argument("--base-url", help="target a live server")
    parser.add_argument("--in-process", action="store_true",
                        help="boot the app in-process (uses OMNI__* env config)")
    parser.add_argument("--ingest", nargs="*", default=[],
                        help="text files to ingest before evaluating (in-process)")
    parser.add_argument("--probe-delay", type=float, default=0.0)
    parser.add_argument("--group-delay", type=float, default=0.0)
    parser.add_argument("--out", help="write the full JSON report here")
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                        help="where the in-process app's engine runs (default cuda)")
    args = parser.parse_args()

    if args.base_url and args.in_process:
        parser.error("--base-url and --in-process are mutually exclusive")
    if args.base_url and args.ingest:
        parser.error(
            "--ingest only works with --in-process (a live server ingests "
            "via POST /api/documents/upload)"
        )
    if not args.base_url and not args.in_process:
        parser.error("choose a target: --in-process or --base-url URL")

    if args.base_url:
        from omni_recall_tpu_torch.eval.clients import HttpApiClient

        client = HttpApiClient(args.base_url)
    else:
        from omni_recall_tpu_torch.device import resolve_device
        from omni_recall_tpu_torch.eval.clients import InProcessClient
        from omni_recall_tpu_torch.server.app import build_app

        try:
            resolve_device(args.device)
        except RuntimeError as exc:
            parser.error(str(exc))
        app = build_app(device=args.device)
        client = InProcessClient(app)
        for path in args.ingest:
            with open(path, encoding="utf-8") as fh:
                app.ingestion_service.ingest(path.split("/")[-1], fh.read(), "file")

    if args.cases:
        cases = load_cases(args.cases)
    elif args.generate:
        cases = generate_cases(client)
    else:
        parser.error("provide --cases FILE or --generate")
        return 2

    harness = EvalHarness(
        client, probe_delay_s=args.probe_delay, group_delay_s=args.group_delay
    )
    report = harness.run(cases)
    if args.out:
        with open(args.out, "w", encoding="utf-8") as fh:
            json.dump(report, fh, indent=2)
    print(json.dumps(report["summary"]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
