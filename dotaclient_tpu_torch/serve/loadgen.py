"""Synthetic load and the re-home parity digest of the serving plane.

Counterpart of the reference's ``scripts/serve_loadgen.py``, in the package::

    python -m dotaclient_tpu_torch.serve.loadgen --addr 127.0.0.1:7788 \\
        --clients 32 --requests 100
    python -m dotaclient_tpu_torch.serve.loadgen --addr 127.0.0.1:7799 \\
        --router --think-ms 30                 # through a SessionRouter
    python -m dotaclient_tpu_torch.serve.loadgen --rehome-parity [--device cpu]

``run_loadgen`` drives N concurrent synthetic games, each a ``ServeClient``
sending sequential step requests, and reports actions/s and round-trip
percentiles (host clock). With ``router=True`` the address names a
``SessionRouter``: clients attach through it and follow its redirects when
a backend dies mid-run. ``run_rehome_parity`` is the in-process proof that
a session moved off a killed backend onto a hot spare resumes bit-exact
under ``serve.carry_shadow``. Each CLI mode prints one JSON line.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import threading
import time
from typing import Any, Dict, List, Optional

import numpy as np


def synthetic_obs(config, rng: np.random.Generator) -> Dict[str, np.ndarray]:
    """One plausible random observation (unbatched leaves; integer leaves
    inside the config's bounds, so the bf16 request wire's exact int casts
    hold). The same draws from the same ``rng`` as the reference's."""
    obs_spec, act = config.obs, config.actions
    U = obs_spec.max_units
    return {
        "units": rng.normal(size=(U, obs_spec.unit_features)).astype(np.float32),
        "unit_mask": np.ones((U,), bool),
        "unit_handles": rng.integers(0, U, size=(U,)).astype(np.int32),
        "globals": rng.normal(size=(obs_spec.global_features,)).astype(np.float32),
        "hero_id": np.asarray(rng.integers(0, config.model.n_hero_ids), np.int32),
        "mask_action_type": np.ones((act.n_action_types,), bool),
        "mask_target_unit": np.ones((act.max_units,), bool),
        "mask_cast_target": np.ones((act.max_units,), bool),
        "mask_ability": np.ones((act.max_abilities,), bool),
    }


def run_loadgen(
    host: str,
    port: int,
    config,
    n_clients: int = 16,
    requests_per_client: int = 50,
    seed: int = 0,
    router: bool = False,
    max_reconnects: int = 6,
    think_s: float = 0.0,
    collect_samples: bool = False,
) -> Dict[str, Any]:
    """N client threads x R sequential requests each, started together.
    The wall clock covers first send to last reply across the fleet, so
    actions/s reflects the server's coalescing. ``think_s`` sleeps between a
    client's requests (a game's frame cadence). The summary also counts
    re-homed sessions and requests that missed their deadline.
    ``collect_samples`` adds each reply's ``(t_end, latency, client)``
    (monotonic clock) under ``samples``, so a caller can split the latency
    curve around a failover (the bench's blackout p99)."""
    from dotaclient_tpu_torch.serve.client import ServeClient, ServeDeadlineError

    latencies: List[List[float]] = [[] for _ in range(n_clients)]
    samples: List[tuple] = []
    lock = threading.Lock()
    versions: set = set()
    errors: List[str] = []
    deadline_errors = [0]
    rehomed = [0]
    barrier = threading.Barrier(n_clients + 1)

    def worker(ci: int) -> None:
        rng = np.random.default_rng(seed + ci)
        try:
            client = ServeClient(host, port, config, router=router, max_reconnects=max_reconnects)
        except Exception as e:  # noqa: BLE001 - attach failed (slots exhausted?): counted
            errors.append(f"attach: {type(e).__name__}: {e}")
            barrier.wait()
            return
        try:
            barrier.wait()  # the fleet starts together: real contention
            for r in range(requests_per_client):
                if think_s > 0 and r:
                    time.sleep(think_s)
                try:
                    client.step(synthetic_obs(config, rng), reset=(r == 0))
                except ServeDeadlineError as e:
                    # the typed bounded failure: counted, the run goes on
                    with lock:
                        deadline_errors[0] += 1
                    errors.append(f"deadline: {e}")
                    continue
                latencies[ci].append(client.last_latency_s)
                versions.add(client.last_version)
                if collect_samples:
                    with lock:
                        samples.append((time.monotonic(), client.last_latency_s, ci))
        except Exception as e:  # noqa: BLE001 - reported in the summary
            errors.append(f"step: {type(e).__name__}: {e}")
        finally:
            with lock:
                rehomed[0] += client.rehomed_count
            client.close()

    threads = [threading.Thread(target=worker, args=(i,), daemon=True) for i in range(n_clients)]
    for t in threads:
        t.start()
    barrier.wait()
    t0 = time.perf_counter()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    flat = sorted(s for per in latencies for s in per)
    n = len(flat)
    out = {
        "clients": n_clients,
        "requests_per_client": requests_per_client,
        "replies": n,
        "errors": len(errors),
        "error_sample": errors[:3],
        "deadline_errors": deadline_errors[0],
        "sessions_rehomed": rehomed[0],
        "actions_per_sec": round(n / wall, 1) if wall > 0 else 0.0,
        "p50_ms": round(flat[n // 2] * 1e3, 3) if n else 0.0,
        "p99_ms": round(flat[min(n - 1, int(n * 0.99))] * 1e3, 3) if n else 0.0,
        "versions_seen": sorted(versions),
    }
    if collect_samples:
        out["samples"] = samples
    return out


def _wait_until(pred, timeout=30.0, poll=0.02):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if pred():
            return True
        time.sleep(poll)
    return pred()


def run_rehome_parity(
    seed: int = 0,
    n_pre: int = 5,
    n_post: int = 5,
    metrics_jsonl: Optional[str] = None,
    device=None,
    config=None,
    params=None,
) -> Dict[str, Any]:
    """The re-home parity digest: a session moved off an abruptly killed
    backend onto a promoted hot spare resumes bit-exact under carry shadow.

    In process: two live backends and one spare behind a ``SessionRouter``,
    every engine on ``device`` with one shared ``params`` dict and serve
    seed, one client per live backend, ``max_batch=1`` and a zero window so
    each request is its own dispatch. After ``n_pre`` steps each, the first
    client's backend dies (listener and connections torn down at once: what
    the wire sees of a SIGKILL); its next step follows the router's redirect
    to the spare and resends the stashed carry row. Every reply of both
    games is then replayed through ``ServeEngine.reference_step`` on carry
    stores of our own, one per backend, the boundary modelled as a host
    copy of the carry row from one store into the other, cast to the store's
    dtype. ``parity == "bitwise"`` needs zero mismatches and the teeth check:
    the first post-kill step replayed from a zeroed carry must differ.

    ``config`` (default: ``RunConfig()`` with the width-8 model) has its
    serve settings replaced by the digest's; ``params`` (default: drawn by
    ``init_params`` from ``seed``) is a state dict of the inference policy.
    """
    import torch

    from dotaclient_tpu_torch.config import ModelConfig, RunConfig
    from dotaclient_tpu_torch.device import resolve_device
    from dotaclient_tpu_torch.models.policy import init_params
    from dotaclient_tpu_torch.serve import (
        PolicyServer,
        ServeClient,
        ServeEngine,
        SessionRouter,
        make_inference_policy,
    )
    from dotaclient_tpu_torch.utils import telemetry

    device = resolve_device(device)
    if config is None:
        config = dataclasses.replace(RunConfig(), model=ModelConfig(unit_embed_dim=8, hidden_dim=8, hero_embed_dim=4))
    cfg = dataclasses.replace(
        config,
        serve=dataclasses.replace(
            config.serve,
            # one request per dispatch: the recorded dispatch indices are
            # exactly the replay's schedule
            max_batch=1, batch_window_ms=0.0, max_slots=4,
            carry_shadow=True, request_wire_dtype="float32",
            request_deadline_s=20.0, request_retries=16,
            router_probe_s=0.1, router_dead_after_s=0.4,
            seed=seed,
        ),
    )
    if params is None:
        with torch.no_grad():
            params = init_params(make_inference_policy(cfg, device="cpu"), torch.Generator().manual_seed(seed)).state_dict()
    regs = [telemetry.Registry() for _ in range(3)]
    engines = [ServeEngine(cfg, make_inference_policy(cfg, device=device), params, registry=r, device=device)
               for r in regs]
    servers = [PolicyServer(e, cfg, registry=r) for e, r in zip(engines, regs)]
    addrs = [tuple(s.address) for s in servers]
    rreg = telemetry.Registry()
    router = SessionRouter(cfg, list(addrs[:2]), spares=[addrs[2]], registry=rreg)

    def rgauges() -> Dict[str, float]:
        counters, gauges = rreg.counters_and_gauges()
        return {**counters, **gauges}

    clients: List[Any] = []
    records: List[List[dict]] = [[], []]
    try:
        if not _wait_until(lambda: rgauges().get("router/backends_live", 0) >= 2
                           and rgauges().get("router/spares_available", 0) >= 1, timeout=15.0):
            raise RuntimeError("the router's probes never confirmed the fleet live")
        rh, rp = router.address[0], int(router.address[1])
        clients = [ServeClient(rh, rp, cfg, router=True) for _ in range(2)]
        vic = next(i for i, c in enumerate(clients) if tuple(c.backend_addr) == addrs[0])
        rngs = [np.random.default_rng(seed + 100 + i) for i in range(2)]

        def step_and_record(ci: int, reset: bool) -> None:
            obs = synthetic_obs(cfg, rngs[ci])
            t0 = time.monotonic()
            c = clients[ci]
            c.step(obs, reset=reset)
            records[ci].append(dict(
                addr=tuple(c.backend_addr), slot=c.slot, didx=c.last_dispatch_idx, obs=obs, reset=reset,
                packed=np.array(c.last_packed, copy=True), logp=c.last_logp, wall_s=time.monotonic() - t0,
            ))

        for r in range(n_pre):
            step_and_record(0, r == 0)
            step_and_record(1, r == 0)
        # the victim's backend dies at once: listener and live connections
        servers[0].close()
        engines[0].stop()
        for r in range(n_post):
            step_and_record(vic, False)
            step_and_record(1 - vic, False)
        rehomed_count = clients[vic].rehomed_count
        rehomed_to = tuple(clients[vic].backend_addr)
    finally:
        for c in clients:
            try:
                c.close()
            except (OSError, ConnectionError):
                pass
        router.close()
        for s in servers[1:]:
            s.close()
        for e in engines[1:]:
            e.stop()

    # the replay: one carry store per backend; the boundary is a host copy
    # of the carry row between stores, as the shadow wire does
    ref = engines[1]  # the same dispatch function, params and serve seed
    stores: Dict[tuple, Any] = {}
    mismatches = 0
    boundary = None
    for ci in (0, 1):
        prev = None
        for rec in records[ci]:
            addr = rec["addr"]
            if addr not in stores:
                stores[addr] = ref.initial_carries()
            if prev is not None and prev["addr"] != addr:
                boundary = rec
                row = [c[prev["slot"]].cpu() for c in stores[prev["addr"]]]
                for c, leaf in zip(stores[addr], row):
                    c[rec["slot"]] = leaf.to(c.device, c.dtype)
            packed, logp, stores[addr] = ref.reference_step(
                [rec["obs"]], [rec["slot"]], [1.0 if rec["reset"] else 0.0], stores[addr], rec["didx"],
            )
            if not (np.array_equal(packed[0], rec["packed"]) and float(logp[0]) == rec["logp"]):
                mismatches += 1
            prev = rec

    # teeth: the same post-kill step from a zeroed carry must disagree, or
    # the parity above proves nothing about the carry transfer
    teeth = False
    if boundary is not None:
        _, zlogp, _ = ref.reference_step(
            [boundary["obs"]], [boundary["slot"]], [0.0], ref.initial_carries(), boundary["didx"],
        )
        teeth = float(zlogp[0]) != boundary["logp"]

    snap = rgauges()
    if metrics_jsonl:
        # one router snapshot line (the reference's --require-router tier)
        sink = telemetry.JsonlSink(metrics_jsonl)
        sink.emit(1, snap)
        sink.close()
    if boundary is None:
        parity = "FAIL: the victim session never re-homed"
    elif mismatches:
        parity = f"FAIL: {mismatches} step(s) diverged from the reference"
    elif not teeth:
        parity = "FAIL: teeth check (zero-carry replay matched too)"
    else:
        parity = "bitwise"
    post = records[vic][n_pre:]
    return {
        "parity": parity,
        "steps": sum(len(r) for r in records),
        "mismatches": mismatches,
        "teeth": teeth,
        "rehomed_sessions": int(rehomed_count > 0),
        "rehomed_to_spare": rehomed_to == addrs[2],
        "blackout_s": round(max((r["wall_s"] for r in post), default=0.0), 3),
        "router_sessions_rehomed": int(snap.get("router/sessions_rehomed_total", 0)),
        "router_spares_promoted": int(snap.get("router/spares_promoted_total", 0)),
        "router_backend_deaths": int(snap.get("router/backend_deaths_total", 0)),
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--addr", type=str, default=None,
                   help="host:port of a running serve server (or, with --router, a session router)")
    p.add_argument("--router", action="store_true",
                   help="--addr names a SessionRouter: clients attach through it and follow its redirects")
    p.add_argument("--clients", type=int, default=16, help="concurrent synthetic games")
    p.add_argument("--requests", type=int, default=50, help="sequential step requests per client")
    p.add_argument("--max-reconnects", type=int, default=6, help="bounded backoff attempts per (re)connect")
    p.add_argument("--think-ms", type=float, default=0.0,
                   help="sleep between a client's requests (a game's frame cadence; 0 = saturate)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--serve", type=str, default=None, metavar="K=V,...",
                   help="ServeConfig overrides for the client side (request_wire_dtype, request_deadline_s, ...)")
    p.add_argument("--rehome-parity", action="store_true",
                   help="ignore --addr: run the in-process re-home parity digest and print it; exit 0 iff bitwise")
    p.add_argument("--metrics-jsonl", type=str, default=None, metavar="PATH",
                   help="with --rehome-parity: also write one router telemetry snapshot line to PATH")
    p.add_argument("--device", type=str, default=None,
                   help="with --rehome-parity: torch device of the engines (default: the current CUDA card)")
    args = p.parse_args(argv)

    if args.rehome_parity:
        out = run_rehome_parity(seed=args.seed, metrics_jsonl=args.metrics_jsonl, device=args.device)
        print(json.dumps(out))
        return 0 if out["parity"] == "bitwise" else 1
    if not args.addr:
        p.error("--addr is required (unless --rehome-parity)")

    from dotaclient_tpu_torch.config import ServeConfig, default_config
    from dotaclient_tpu_torch.utils.overrides import parse_dataclass_overrides

    config = default_config()
    if args.serve:
        try:
            over = parse_dataclass_overrides(ServeConfig, args.serve, "--serve")
        except ValueError as e:
            p.error(str(e))
        config = dataclasses.replace(config, serve=dataclasses.replace(config.serve, **over))
    host, port = args.addr.rsplit(":", 1)
    out = run_loadgen(host, int(port), config, n_clients=args.clients, requests_per_client=args.requests,
                      seed=args.seed, router=args.router, max_reconnects=args.max_reconnects,
                      think_s=args.think_ms / 1e3)
    print(json.dumps(out))
    return 0 if not out["errors"] else 1


if __name__ == "__main__":
    sys.exit(main())
