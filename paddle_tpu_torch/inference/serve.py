"""`python -m paddle_tpu_torch.inference.serve` — run the streaming HTTP
serving front-end over a saved model (counterpart of
paddle_tpu/inference/serve.py; same CLI plus --device).

Artifact: `<prefix>.pt` + `<prefix>.config.json` (or --config), as
written by `gateway.save_for_serving`. Serves `POST /v1/generate` (one
SSE frame a tick, with every token the tick produced: several when
speculative drafts were accepted) and `GET /healthz` (the engine's
health snapshot: the SLO layer's queue depth, degradation and
counters, and the `speculative` block: armed, the draft cap, drafted,
accepted, acceptance rate). The engine runs the SLO layer (FLAGS_serving_slo,
default on): a request's `priority` and `deadline_s` are honoured, a
full queue (--max-queue-tokens) answers 429 with Retry-After, and a
deadline that passes answers 504 (`"stream": false`) or an error frame.
Observability is armed, as in the reference's server: `GET /metrics`
answers the Prometheus text (the `serving.*` series, per-step
`xla.dispatch_seconds` / `xla.execute_seconds{executable=...}`, the
`serving.attribution_seconds{bucket=...}` ledger with trace-id
exemplars), and request tracing (FLAGS_request_trace, default on)
answers `GET /v1/trace/<id>` for the id in each response's
`X-Request-Id` header. `--metrics-port N` also serves /metrics and
/healthz on a port of their own (FLAGS_metrics_port). Prints `serving
on http://<host>:<port>` once listening.

Signals: SIGTERM/SIGINT start a graceful drain — /healthz flips to 503,
new submits get 503, in-flight streams finish (bounded by
--drain-timeout), then the process exits 0. A second signal exits
immediately.

Example:
  python -m paddle_tpu_torch.inference.serve --model /path/m --port 8008
  curl -N localhost:8008/v1/generate \\
      -d '{"prompt": [3, 5, 7], "max_new_tokens": 8}'
  curl localhost:8008/v1/trace/<X-Request-Id>; curl localhost:8008/metrics
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
                   help="queue bound behind the 429 backpressure path "
                        "(default: 8 * max_seq)")
    p.add_argument("--quantize", choices=("int8",), default=None,
                   help="weight-only int8 projections (the W8A16 kernel)")
    p.add_argument("--max-draft-tokens", type=int, default=None,
                   help="self-speculative draft-length cap (default "
                        "FLAGS_speculative_draft_tokens, 4; 0 disables "
                        "drafting for this engine); GET /healthz reports "
                        "it under engine.speculative with the drafted and "
                        "accepted counts")
    p.add_argument("--keepalive-s", type=float, default=0.5,
                   help="SSE keepalive interval (doubles as the "
                        "client-disconnect probe)")
    p.add_argument("--drain-timeout", type=float, default=30.0)
    p.add_argument("--metrics-port", type=int, default=0,
                   help="also serve the standalone observability "
                        "/metrics endpoint (FLAGS_metrics_port)")
    return p


def main(argv=None):
    args = _build_parser().parse_args(argv)
    from .. import observability as obs
    from ..framework import core as _core
    from . import gateway as gw

    obs.enable(True)
    if args.metrics_port:
        _core.set_flags({"FLAGS_metrics_port": args.metrics_port})

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
          f"(POST /v1/generate, GET /healthz, /metrics, /v1/trace/<id>) "
          f"on {engine.device}",
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
