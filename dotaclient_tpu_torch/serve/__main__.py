"""Standalone policy-serving server on one CUDA card.

    python -m dotaclient_tpu_torch.serve --checkpoint runs/ckpt
    python -m dotaclient_tpu_torch.serve --checkpoint runs/ckpt \\
        --serve batch_window_ms=4,max_batch=128 --serve-listen 0.0.0.0:7788
    python -m dotaclient_tpu_torch.serve --checkpoint runs/ckpt \\
        --subscribe 10.0.0.5:7777          # hot weight refresh from a learner
    python -m dotaclient_tpu_torch.serve --checkpoint runs/ckpt \
        --subscribe shm://NAME             # ... from a learner's shm lane on this host
    python -m dotaclient_tpu_torch.serve --checkpoint runs/ckpt --device cpu

Counterpart of ``dotaclient_tpu/serve/__main__.py``. Loads a checkpoint the
port's learner wrote (``--checkpoint-dir``) into the inference-only tree,
serves actions over the socket lane (clients are ``serve.ServeClient``, one
per game; a JAX client works too), and with ``--subscribe`` hot-swaps newer
weights frames from a learner's fanout between dispatches. Prints
``serve: listening on ...`` and ``SERVE_LISTENING {"host", "port"}`` at
start, after one warm-up dispatch, and one JSON line of serve totals when it stops (``--duration`` or
SIGINT), with the ``lstm_seq`` kernel's launches in this process (the
warm-up's included) and the rollout codec's calls by path in the run
(``native_decodes``, ``native_encodes``, ``proto_fallbacks``: the requests
and replies). Without a card it raises unless ``--device cpu`` is
given. A fleet is several of these behind ``python -m
dotaclient_tpu_torch.serve.router``, each started with
``--serve carry_shadow=true`` where sessions must resume bit-exact when
re-homed.

``--subscribe shm://NAME`` reads the weights slab of a learner's shm lane
on this host (it claims one of the lane's actor slots while it runs).
With ``--subscribe`` the server also ships its registry's fleet snapshot
(``utils/fleet.py`` ``FleetPublisher``, peer ``s<listen port>``) back over
that lane every ``--fleet-interval`` seconds (``telemetry.fleet_interval_s``,
5 s, by default; 0 turns it off), the first at once.

``--trace-jsonl PATH`` installs the process tracer before the engine and
server are built (``utils/tracing.py``; ``--trace-sample N``, default
``telemetry.trace_sample_n``): a traced request's record gets its
``recv`` and ``reply`` hops here and a ``serve_request`` event in PATH;
the log is drained and closed at exit. ``utils/trace_report.py`` joins it
with the clients' logs.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--checkpoint", type=str, required=True,
                   help="checkpoint directory of the port's learner; its stored config governs the model")
    p.add_argument("--serve-listen", type=str, default="127.0.0.1:0",
                   help="host:port of the serve lane (port 0 = ephemeral, printed at startup)")
    p.add_argument("--serve", type=str, default=None, metavar="K=V,...",
                   help="comma-separated ServeConfig overrides, e.g. 'batch_window_ms=4,max_batch=128'")
    p.add_argument("--subscribe", type=str, default=None, metavar="ADDR",
                   help="weights fanout to subscribe to: 'host:port' of a learner's socket lane, or "
                   "'shm://NAME' of its shm lane on this host")
    p.add_argument("--serve-metrics-jsonl", type=str, default=None, metavar="PATH",
                   help="append a serve-telemetry snapshot to PATH every 5 s and at exit")
    p.add_argument("--trace-jsonl", type=str, default=None, metavar="PATH",
                   help="append sampled trace events (traced requests' serve_request events) as JSON lines to PATH; "
                   "join them with the clients' by python -m dotaclient_tpu_torch.utils.trace_report")
    p.add_argument("--trace-sample", type=int, default=None, metavar="N",
                   help="with --trace-jsonl: the sample cadence of this process's own sampling decisions "
                   "(default telemetry.trace_sample_n = 16); the server stamps every traced request it receives")
    p.add_argument("--fleet-interval", type=float, default=None, metavar="S",
                   help="with --subscribe: ship a fleet metrics snapshot on the subscription lane every S "
                   "seconds (default telemetry.fleet_interval_s = 5; 0 disables)")
    p.add_argument("--duration", type=float, default=0.0,
                   help="serve for this many seconds then exit (0 = until SIGINT)")
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: the current CUDA card; 'cpu' must be asked for)")
    args = p.parse_args(argv)

    from dotaclient_tpu_torch.config import ServeConfig
    from dotaclient_tpu_torch.device import resolve_device
    from dotaclient_tpu_torch.ops import lstm
    from dotaclient_tpu_torch.serve import (
        PolicyServer,
        ServeEngine,
        load_inference_params,
        make_inference_policy,
    )
    from dotaclient_tpu_torch.transport import serialize
    from dotaclient_tpu_torch.utils import telemetry, tracing
    from dotaclient_tpu_torch.utils.overrides import parse_dataclass_overrides

    calls0 = serialize.codec_calls()

    device = resolve_device(args.device)  # raises without a card unless asked for the CPU
    if device.type == "cuda":
        from dotaclient_tpu_torch.ops import build

        # compile (or load) the kernels now, not inside the first request
        t0 = time.perf_counter()
        build.kernel_library()
        print(f"serve: kernels ready in {time.perf_counter() - t0:.1f} s", flush=True)
    config, params, version = load_inference_params(args.checkpoint)
    if args.serve:
        try:
            over = parse_dataclass_overrides(ServeConfig, args.serve, "--serve")
        except ValueError as e:
            p.error(str(e))
        config = dataclasses.replace(config, serve=dataclasses.replace(config.serve, **over))

    if args.trace_jsonl:
        # before the engine and the server exist
        tracing.configure(args.trace_jsonl, sample_n=args.trace_sample)
    engine = ServeEngine(config, make_inference_policy(config, device=device), params,
                         version=version, device=device)
    # the device's first calls happen here, not inside a game's first request
    print(f"serve: warm-up dispatch in {engine.warm_up():.2f} s", flush=True)
    host, port = args.serve_listen.rsplit(":", 1)
    server = PolicyServer(engine, config, host=host, port=int(port))
    print(
        f"serve: listening on {server.address} (window {config.serve.batch_window_ms} ms, "
        f"max_batch {config.serve.max_batch}, {config.serve.max_slots} carry slots, weights v{version}, "
        f"device {device})",
        flush=True,
    )
    # the machine-readable address line tools parse
    print("SERVE_LISTENING " + json.dumps({"host": server.address[0], "port": int(server.address[1])}), flush=True)

    source = None
    if args.subscribe:
        if args.subscribe.startswith("shm://"):
            from dotaclient_tpu_torch.transport.shm_transport import ShmTransport

            source = ShmTransport(args.subscribe[len("shm://"):])
        else:
            from dotaclient_tpu_torch.transport.socket_transport import SocketTransport

            sub_host, sub_port = args.subscribe.rsplit(":", 1)
            source = SocketTransport(sub_host, int(sub_port))
        server.attach_weights_source(source)
        print(f"serve: subscribed to weights fanout {args.subscribe}", flush=True)

    publisher = None
    if source is not None:
        from dotaclient_tpu_torch.utils.fleet import FleetPublisher

        interval = telemetry.fleet_interval_s if args.fleet_interval is None else args.fleet_interval
        if interval > 0:
            # the peer id is the listen port, not the pid: a restarted
            # server reuses its fleet row
            publisher = FleetPublisher(peer_id=int(server.address[1]) & 0xFFFF, kind="serve",
                                       interval_s=interval)

    sink = telemetry.JsonlSink(args.serve_metrics_jsonl) if args.serve_metrics_jsonl else None
    tel = telemetry.get_registry()
    t_end = time.time() + args.duration if args.duration else None
    # the wake follows the fleet cadence; the JSONL sink keeps its own 5 s
    wake = min(5.0, publisher.interval_s) if publisher is not None else 5.0
    sink_every, last_sink = 5.0, time.monotonic()
    try:
        while t_end is None or time.time() < t_end:
            if publisher is not None:
                try:
                    publisher.maybe_publish(source)
                except (ConnectionError, OSError):
                    pass   # the learner is gone: serving goes on with the last weights
            time.sleep(max(0.0, min(wake, t_end - time.time())) if t_end else wake)
            if sink is not None and time.monotonic() - last_sink >= sink_every:
                last_sink = time.monotonic()
                snap = tel.snapshot()
                sink.emit(int(snap.get("serve/dispatches_total", 0)), snap)
    except KeyboardInterrupt:
        pass
    finally:
        server.close()
        engine.stop()
        if source is not None:
            source.close()
        if args.trace_jsonl:
            tracing.shutdown()   # drain and fsync the trace log
        snap = tel.snapshot()
        if sink is not None:
            sink.emit(int(snap.get("serve/dispatches_total", 0)), snap)
            sink.close()
        print(json.dumps({
            "serve_requests_total": snap.get("serve/requests_total", 0.0),
            "serve_dispatches_total": snap.get("serve/dispatches_total", 0.0),
            "serve_p99_latency_ms": snap.get("serve/p99_latency_ms", 0.0),
            "serve_weights_version": snap.get("serve/weights_version", 0.0),
            "lstm_seq_launches": lstm.lstm_sequence_kernel.launches,
            **{k: v - calls0[k] for k, v in serialize.codec_calls().items()},
        }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
