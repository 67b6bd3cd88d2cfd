"""`python -m paddle_tpu_torch.inference.serve` — run the streaming HTTP
serving front-end over a saved model (counterpart of
paddle_tpu/inference/serve.py; same CLI plus --device).

Artifact: `<prefix>.pt` + `<prefix>.config.json` (or --config), as
written by `gateway.save_for_serving`. Serves `POST /v1/generate` and
`GET /healthz`. Prints `serving on http://<host>:<port>` once listening.

Signals: SIGTERM/SIGINT start a graceful drain — /healthz flips to 503,
new submits get 503, in-flight streams finish (bounded by
--drain-timeout), then the process exits 0. A second signal exits
immediately.

Example:
  python -m paddle_tpu_torch.inference.serve --model /path/m --port 8008
  curl -N localhost:8008/v1/generate \\
      -d '{"prompt": [3, 5, 7], "max_new_tokens": 8}'
"""
from __future__ import annotations

import argparse
import os
import signal
import sys
import threading


def _build_parser():
    p = argparse.ArgumentParser(
        prog="python -m paddle_tpu_torch.inference.serve",
        description="streaming HTTP gateway over the continuous-"
                    "batching engine (PyTorch/CUDA port)")
    p.add_argument("--model", required=True,
                   help="artifact path prefix (<prefix>.pt)")
    p.add_argument("--config", default=None,
                   help="LlamaConfig preset name (llama_tiny...) or "
                        "JSON file; default: <prefix>.config.json")
    p.add_argument("--device", default="cuda",
                   help="torch device the engine runs on (default cuda; "
                        "cpu runs the plain PyTorch route)")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8000,
                   help="0 picks a free port (printed at startup)")
    p.add_argument("--max-batch", type=int, default=4)
    p.add_argument("--max-seq", type=int, default=256)
    p.add_argument("--page-size", type=int, default=16)
    p.add_argument("--total-pages", type=int, default=None)
    p.add_argument("--max-chunk-tokens", type=int, default=64)
    p.add_argument("--max-queue-tokens", type=int, default=None,
                   help="queue bound behind the 429 path (SLO layer; "
                        "not ported yet — setting it is an error)")
    p.add_argument("--quantize", choices=("int8",), default=None,
                   help="not ported yet — setting it is an error")
    p.add_argument("--max-draft-tokens", type=int, default=None,
                   help="self-speculative draft-length cap (speculation "
                        "is not ported yet; accepted and unused)")
    p.add_argument("--keepalive-s", type=float, default=0.5,
                   help="SSE keepalive interval (doubles as the "
                        "client-disconnect probe)")
    p.add_argument("--drain-timeout", type=float, default=30.0)
    return p


def main(argv=None):
    args = _build_parser().parse_args(argv)
    from . import gateway as gw

    if not os.path.exists(args.model + ".pt"):
        print(f"no servable artifact at {args.model!r} (need "
              f"<prefix>.pt)", file=sys.stderr)
        return 2
    model = gw.load_generation_model(args.model, config=args.config,
                                     device=args.device)
    engine = gw.build_engine(
        model, max_batch=args.max_batch, max_seq=args.max_seq,
        page_size=args.page_size, total_pages=args.total_pages,
        max_chunk_tokens=args.max_chunk_tokens,
        max_queue_tokens=args.max_queue_tokens,
        max_draft_tokens=args.max_draft_tokens,
        quantize=args.quantize, device=args.device)
    g = gw.ServingGateway(runner=gw.EngineRunner(engine), host=args.host,
                          port=args.port, keepalive_s=args.keepalive_s)
    port = g.start()
    print(f"serving on http://{args.host}:{port}  "
          f"(POST /v1/generate, GET /healthz) on {engine.device}",
          flush=True)

    stop = threading.Event()

    def _drain_then_stop():
        g.drain(timeout=args.drain_timeout)
        stop.set()

    def _on_signal(signum, frame):
        if g.draining:                  # second signal: leave now
            stop.set()
            return
        print(f"signal {signum}: draining "
              f"(timeout {args.drain_timeout}s)", flush=True)
        threading.Thread(target=_drain_then_stop, daemon=True,
                         name="paddle-serve-drain").start()

    signal.signal(signal.SIGTERM, _on_signal)
    signal.signal(signal.SIGINT, _on_signal)
    try:
        stop.wait()
    finally:
        g.stop()
    print("drained, bye", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
