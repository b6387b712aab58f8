"""The actor process: one rollout worker of the scale-out topology.

Counterpart of ``dotaclient_tpu/actor/__main__.py``. N such processes feed one
learner over TCP or, on the learner's host, over shared memory::

    python -m dotaclient_tpu_torch.actor --connect HOST:PORT|shm://NAME | --amqp HOST[:PORT] [--n-envs 64]
        [--opponent selfplay] [--team-size 1] [--max-dota-time S] [--rollout-len T]
        [--rollout-wire-dtype float32|bfloat16] [--seed S] [--steps N]
        [--refresh-every N] [--max-reconnects N] [--idle-timeout S] [--fleet-interval S] [--platform cuda|cpu]
        [--trace-jsonl PATH] [--trace-sample N]

It connects to the learner's ``TransportServer`` (``python -m
dotaclient_tpu_torch.train.learner --transport socket --listen HOST:PORT``)
or claims a ring slot of its ``ShmTransportServer`` (``--transport shm
--shm-name NAME``, then ``--connect shm://NAME``), or, with ``--amqp
HOST[:PORT]`` (exclusive with ``--connect``), reaches it through a RabbitMQ
broker (``--transport amqp``; needs ``pika``). It waits up to 60 s for the
first weights frame (the Flax layout, converted, a bf16 frame widened),
runs ``VecActorPool`` and ships rollouts encoded by the native codec
(``--rollout-wire-dtype bfloat16`` narrows them as
``transport.rollout_wire_dtype`` does: give the learner the same), applying
newer weights every ``--refresh-every`` env steps. It reads a JAX learner's frames too,
and a JAX learner reads its rollouts. Actors are disposable: a lost
connection is retried with bounded exponential backoff and full jitter
(``actor/backoff.py``), then the process exits 1 for its supervisor to
restart. The first SIGTERM or SIGINT stops at the next slice, ships every
lane's partial chunk and exits 0; a second one kills. The last lines are
``ACTOR_VERSIONS_SEEN [...]`` (every weights version applied) and
``ACTOR_STATS {...}`` (env steps, steps, chunks shipped, steps/s, the
version, the policy steps the ``lstm_seq`` kernel ran, and the rollout
codec's calls by path: ``native_encodes``, ``native_decodes``,
``proto_fallbacks``).

The process ships its registry's fleet snapshot (``utils/fleet.py``
``FleetPublisher``, peer ``a<seed>``) over the same transport at each
weights refresh, at most once every ``--fleet-interval`` seconds
(``telemetry.fleet_interval_s``, 5 s, by default; 0 turns it off): the
learner's ``FleetAggregator`` reads the actors' episode outcomes and their
``util/actor/*`` phases from them. The pool's utilization plane folds at
the same cadence (the reference's actor folds every 5 s whatever
``--fleet-interval`` says).

``--trace-jsonl PATH`` installs the process tracer before the pool is
built (``utils/tracing.py``; ``--trace-sample N``, default
``telemetry.trace_sample_n``): every Nth shipped chunk carries a trace
record, emitted to PATH with the pool's weights ``apply`` events; the log
is drained and closed at exit. ``utils/trace_report.py`` joins it with the
learner's.

``--platform`` is ``cuda`` by default, as every entry point of the port:
the policy steps on the card, and with no card the process raises. The JAX
actor defaults to its CPU because there the learner owns the one TPU; a
card admits many processes. ``--platform cpu`` runs the policy on the CPU
(a try without a card).

``--seed`` defaults to the CRC32 of ``$POD_NAME`` (0 outside k8s), so the
replicas of a fleet stream different experience; it also seeds the
reconnect backoff's jitter.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import signal
import sys
import time
import zlib
from typing import List, Optional

def transport_factory(connect: Optional[str], idle_timeout: Optional[float], transport_config,
                      amqp: Optional[str] = None):
    """The (re)connect callable: an ``AmqpTransport`` to broker HOST[:PORT]
    for ``amqp``, a ``ShmTransport`` on lane NAME for ``shm://NAME``, else a
    ``SocketTransport`` to HOST:PORT with the config's liveness and poison
    knobs (the wire carries no config handshake, so they must match the
    learner's)."""
    if amqp is not None:
        from dotaclient_tpu_torch.transport.queues import AmqpTransport

        host, _, port = amqp.partition(":")
        return lambda: AmqpTransport(host, int(port or 5672))
    if connect.startswith("shm://"):
        from dotaclient_tpu_torch.transport.shm_transport import ShmTransport

        name = connect[len("shm://"):]
        return lambda: ShmTransport(name)
    from dotaclient_tpu_torch.transport.socket_transport import SocketTransport

    host, port = connect.rsplit(":", 1)
    idle = idle_timeout if idle_timeout is not None else transport_config.idle_timeout_s
    return lambda: SocketTransport(host, int(port), idle_timeout_s=idle,
                                   poison_frame_limit=transport_config.poison_frame_limit)


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(description="One rollout worker feeding a learner over TCP or shared memory.")
    p.add_argument("--connect", type=str, default=None,
                   help="the learner's TransportServer, HOST:PORT, or shm://NAME for its same-host shm lane")
    p.add_argument("--amqp", type=str, default=None, metavar="HOST[:PORT]",
                   help="a RabbitMQ broker instead of --connect (the learner's --transport amqp; needs pika)")
    p.add_argument("--n-envs", type=int, default=64)
    p.add_argument("--opponent", type=str, default="scripted_easy",
                   choices=("scripted_easy", "scripted_hard", "selfplay", "league"))
    p.add_argument("--team-size", type=int, default=1)
    p.add_argument("--max-dota-time", type=float, default=None,
                   help="episode horizon in game seconds (default EnvConfig.max_dota_time)")
    p.add_argument("--rollout-len", type=int, default=None,
                   help="chunk length T; must match the learner's ppo.rollout_len (skewed chunks are dropped)")
    p.add_argument("--rollout-wire-dtype", type=str, default=None, choices=("float32", "bfloat16"),
                   help="the rollouts' wire dtype (transport.rollout_wire_dtype; the learner's value): bfloat16 "
                   "about halves the shipped bytes, behavior_logp, rewards, dones, values and the carries stay f32")
    p.add_argument("--seed", type=int, default=None, help="default: CRC32 of $POD_NAME, or 0")
    p.add_argument("--steps", type=int, default=0, help="stop after N env steps (0: run until stopped)")
    p.add_argument("--refresh-every", type=int, default=8, help="poll for new weights every N env steps")
    p.add_argument("--platform", type=str, default="cuda", choices=("cuda", "cpu"),
                   help="where the policy steps (default: the current CUDA card; raises without one)")
    p.add_argument("--max-reconnects", type=int, default=6,
                   help="connect attempts (exponential backoff and jitter) before exiting 1")
    p.add_argument("--idle-timeout", type=float, default=None,
                   help="seconds of learner silence before the connection counts as lost "
                   "(default transport.idle_timeout_s; 0 disables)")
    p.add_argument("--trace-jsonl", type=str, default=None, metavar="PATH",
                   help="append sampled trace events (shipped chunks' records, weights applies) as JSON lines to "
                   "PATH; join them with the learner's by python -m dotaclient_tpu_torch.utils.trace_report")
    p.add_argument("--trace-sample", type=int, default=None, metavar="N",
                   help="with --trace-jsonl: trace every Nth shipped chunk (default telemetry.trace_sample_n = 16)")
    p.add_argument("--fleet-interval", type=float, default=None, metavar="S",
                   help="ship a fleet metrics snapshot at most every S seconds, at weights refreshes "
                   "(default telemetry.fleet_interval_s = 5; 0 disables)")
    args = p.parse_args(argv)
    if bool(args.connect) == bool(args.amqp):
        p.error("exactly one of --connect HOST:PORT (or shm://NAME) and --amqp HOST[:PORT] is required")
    if args.seed is None:
        pod = os.environ.get("POD_NAME", "")
        args.seed = zlib.crc32(pod.encode()) & 0x7FFFFFFF if pod else 0

    from dotaclient_tpu_torch.utils import telemetry, tracing

    fleet_interval0 = telemetry.fleet_interval_s
    if args.fleet_interval is not None:
        # the pool's utilization plane folds at the snapshot cadence
        # (restored at the end, for embedding programs)
        telemetry.fleet_interval_s = args.fleet_interval
    if args.trace_jsonl:
        # before the pool, which takes tracing.get() at init
        tracing.configure(args.trace_jsonl, sample_n=args.trace_sample)
    try:
        return _run(args)
    finally:
        telemetry.fleet_interval_s = fleet_interval0
        if args.trace_jsonl:
            # drain and fsync the log (a SIGKILL skips this: the writer's
            # per-batch flush leaves at most a torn last line)
            tracing.shutdown()


def _run(args: argparse.Namespace) -> int:
    """Connect, wait for the first weights, run the pool, print the closing
    lines."""
    # the first SIGTERM or SIGINT drains: flush the partial chunks, exit 0;
    # the handler then restores the default, so a second one kills
    stop = {"stop": False}

    def graceful(signum, frame):
        stop["stop"] = True
        signal.signal(signum, signal.SIG_DFL)
        print(f"actor: {signal.Signals(signum).name} received: flushing partial rollouts and exiting "
              "(signal again to force)", file=sys.stderr, flush=True)

    try:
        signal.signal(signal.SIGTERM, graceful)
        signal.signal(signal.SIGINT, graceful)
    except ValueError:
        pass   # not the main thread: signals stay with the embedding program

    import random

    import torch

    from dotaclient_tpu_torch.actor.backoff import connect_with_backoff
    from dotaclient_tpu_torch.actor.vec_runtime import VecActorPool
    from dotaclient_tpu_torch.config import default_config
    from dotaclient_tpu_torch.device import resolve_device
    from dotaclient_tpu_torch.models.convert import convert
    from dotaclient_tpu_torch.models.policy import init_params, make_policy
    from dotaclient_tpu_torch.ops import lstm
    from dotaclient_tpu_torch.transport import serialize
    from dotaclient_tpu_torch.transport.serialize import decode_weights
    from dotaclient_tpu_torch.utils import fleet

    device = resolve_device(None if args.platform == "cuda" else "cpu")
    config = default_config()
    env_over = dict(n_envs=args.n_envs, opponent=args.opponent, team_size=args.team_size)
    if args.max_dota_time is not None:
        env_over["max_dota_time"] = args.max_dota_time
    config = dataclasses.replace(config, env=dataclasses.replace(config.env, **env_over))
    if args.rollout_len is not None:
        config = dataclasses.replace(config, ppo=dataclasses.replace(config.ppo, rollout_len=args.rollout_len))
    if args.rollout_wire_dtype is not None:
        config = dataclasses.replace(config, transport=dataclasses.replace(
            config.transport, rollout_wire_dtype=args.rollout_wire_dtype))

    factory = transport_factory(args.connect, args.idle_timeout, config.transport, amqp=args.amqp)
    # the backoff's jitter from the seed, as the reference's
    backoff_rng = random.Random(args.seed)

    try:
        transport = connect_with_backoff(factory, max_attempts=args.max_reconnects, rng=backoff_rng,
                                         should_abort=lambda: stop["stop"])
    except (ConnectionError, OSError) as e:
        print(f"actor: cannot reach the learner ({e}); exiting for a restart", file=sys.stderr, flush=True)
        return 1
    policy = make_policy(config.model, config.obs, config.actions, device=device)
    init_params(policy, torch.Generator().manual_seed(args.seed))
    local = policy.state_dict()

    # wait for the learner's first weights: chunks from a random init would
    # carry version 0 beside the learner's own count
    params, version = None, 0
    deadline = time.time() + 60.0
    while time.time() < deadline and not stop["stop"]:
        try:
            msg = transport.latest_weights()
        except ConnectionError as e:
            print(f"actor: learner lost while waiting for weights ({e}); exiting for a restart",
                  file=sys.stderr, flush=True)
            return 1
        if msg is not None:
            version, tree = decode_weights(msg)
            try:
                got = convert(tree)
            except KeyError as e:
                print(f"actor: the learner's weights tree differs from this actor's model config ({e}): "
                      "align the configs", file=sys.stderr, flush=True)
                return 2
            # the wire carries no config handshake: a learner with other
            # shapes fails here, not deep in the policy or the ring
            bad = [f"{k}: learner {tuple(got[k].shape)} vs actor {tuple(v.shape)}"
                   for k, v in local.items() if k not in got or got[k].shape != v.shape]
            if bad:
                print("actor: the learner's weights do not match this actor's model config (align the "
                      "configs):\n  " + "\n  ".join(bad[:5]), file=sys.stderr, flush=True)
                return 2
            params = {k: v.to(device) for k, v in got.items()}
            break
        time.sleep(0.1)
    if params is None:
        print("actor: no weights from the learner within 60 s; starting from the local init",
              file=sys.stderr, flush=True)
        params = {k: v.detach().clone() for k, v in local.items()}

    # before the pool, which takes fleet.get() at init; the peer id is the
    # seed, so a restarted actor reports under the same fleet row
    fleet.configure(peer_id=args.seed, kind="actor", interval_s=args.fleet_interval)
    try:
        pool = VecActorPool(config, policy, params, transport=transport, seed=args.seed, version=version,
                            device=device)
        launches0 = lstm.lstm_sequence_kernel.launches
        calls0 = serialize.codec_calls()
        t0 = time.time()
        steps = 0
        while (not args.steps or steps < args.steps) and not stop["stop"]:
            try:
                pool.run(args.refresh_every, refresh_every=args.refresh_every)
            except (ConnectionError, OSError) as e:
                if stop["stop"]:
                    break   # stopping anyway: drain instead of reconnecting
                print(f"actor: transport lost ({e}); reconnecting", file=sys.stderr, flush=True)
                transport.close()
                try:
                    transport = connect_with_backoff(factory, max_attempts=args.max_reconnects, rng=backoff_rng,
                                                     should_abort=lambda: stop["stop"])
                except (ConnectionError, OSError) as e2:
                    if stop["stop"]:
                        break   # a stop during the backoff: a clean drain
                    print(f"actor: reconnect failed ({e2}); exiting for a restart", file=sys.stderr,
                          flush=True)
                    return 1
                pool.transport = transport
                continue
            steps += args.refresh_every
            if steps % 256 == 0:
                s = pool.stats()
                print(f"[actor {args.seed}] {s['env_steps']:.0f} env steps, {s['rollouts_shipped']:.0f} "
                      f"rollouts, {s['env_steps'] / max(time.time() - t0, 1e-9):.0f} steps/s, version "
                      f"{pool.version}", flush=True)
        elapsed = time.time() - t0
        if stop["stop"]:
            # every lane's partial chunk is real experience; best effort: a
            # transport that died with the stop must not fail a clean drain
            try:
                n = pool.flush_partial()
                print(f"actor: graceful stop: flushed {n} partial rollouts", file=sys.stderr, flush=True)
            except (ConnectionError, OSError) as e:
                print(f"actor: graceful stop: flush failed ({e})", file=sys.stderr, flush=True)
        s = pool.stats()
        print("ACTOR_VERSIONS_SEEN " + json.dumps(sorted(pool.versions_applied)), flush=True)
        print("ACTOR_STATS " + json.dumps({
            "seed": args.seed, "env_steps": s["env_steps"], "steps": pool.steps,
            "rollouts_shipped": s["rollouts_shipped"],
            "episodes_done": s["episodes_done"], "env_steps_per_sec": s["env_steps"] / max(elapsed, 1e-9),
            "elapsed_sec": elapsed, "version": pool.version,
            "lstm_seq_launches": lstm.lstm_sequence_kernel.launches - launches0,
            **{k: v - calls0[k] for k, v in serialize.codec_calls().items()},
        }, sort_keys=True), flush=True)
        transport.close()
        return 0
    finally:
        fleet.shutdown()


if __name__ == "__main__":
    sys.exit(main())
