"""Run the Omni Recall server on the GPU: ``python -m omni_recall_tpu_torch.server``.

The engine runs on CUDA; ``--device cpu`` runs the plain PyTorch versions
of the kernels on the CPU instead (only when asked).
"""

from __future__ import annotations

import argparse
import logging
from wsgiref.simple_server import WSGIServer, make_server
from socketserver import ThreadingMixIn

from omni_recall_tpu_torch.config import load_config
from omni_recall_tpu_torch.server.app import build_app


class ThreadingWSGIServer(ThreadingMixIn, WSGIServer):
    daemon_threads = True


def main() -> None:
    parser = argparse.ArgumentParser(description="Omni Recall server (PyTorch + CUDA)")
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=8080)
    parser.add_argument("--settings", default=None, help="appsettings.json path")
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                        help="where the engine runs (default cuda)")
    args = parser.parse_args()

    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(levelname)s %(name)s: %(message)s")
    config = load_config(settings_file=args.settings)
    app = build_app(config, device=args.device)
    with make_server(args.host, args.port, app, server_class=ThreadingWSGIServer) as server:
        logging.getLogger(__name__).info(
            "Omni Recall listening on http://%s:%d (engine backend=%s, device=%s)",
            args.host, args.port, config.engine.backend, args.device,
        )
        server.serve_forever()


if __name__ == "__main__":
    main()
