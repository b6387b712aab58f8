"""Multi-GPU preflight and the fused-parity verdict for the port.

The counterpart of the JAX package's ``scripts/run_multichip.py`` (and of
the dry run its ``__graft_entry__.dryrun_multichip`` provides), for
``torch.distributed`` on CUDA. One JSON result line each, with the keys of
``MULTICHIP_r01.json`` (``n_devices``, ``mode``, ``rc``, ``ok``, ``skipped``,
``tail`` / ``reason`` / ``remediation``):

* **preflight** (the default): FIRST a fresh child process with no device
  pin runs what trips a broken environment (``torch.cuda.init()``, the
  device count, one small op on the card); THEN the dry run: one
  data-parallel global-batch update (``train/ppo.py``'s step over the
  mesh's batch group) at world N, one process a rank, over NCCL when each
  rank has a card of its own and gloo when they share one. A broken
  environment (an old driver, no card, a card out of memory or held by
  another process, an NCCL init that fails, an init that HANGS, cut by a
  timeout) is a SKIP line with a remediation, never a traceback. Only the
  init is classified: the card's init child, and a rank's output until it
  has joined the world (its process group up and one all-reduce through
  it, when it prints ``MULTICHIP_RANK_JOINED``). A failure after that is a
  fault of the path under test, reported with its tail and exit code 1,
  whatever its text.
* **--force-host N**: the same dry run on N gloo CPU processes.
* **--fused-parity N**: the fused iteration (``train/fused.py``, the
  lane-sharded actor of ``actor/device_rollout.py``) at world 1 and world
  N, one process a rank; compares the per-dispatch losses and a float64
  param L1 at reassociation tolerance, and requires at N the lane-sharding
  proof: each rank's actor state holds ``lanes / N`` rows, read off the
  state.
* **--probe**: the measurement of the bench's multichip stage. The
  learner's epoch step (``train/ppo.py`` ``make_epoch_step``) at the
  default shapes with E=2 and M=2, so each call runs the multi-update
  program (the minibatch gathers, the gradient all-reduce an update), at
  world N: optimizer frames/s (best of 2 timed segments) and a
  deterministic parity digest (each step's loss and the params' float64 L1
  from the seed's params and the learner's minibatch permutation stream).
  The bench runs it at world 1 and world N and compares the digests.
* **--fused**: the same contract for the fused iteration at world N, with
  the lane-sharding proof of ``--fused-parity``.

Every mode runs its ranks through the preflight's world: over NCCL when
each rank has a card of its own, over gloo when they share one
(``--devices`` above the card count), on gloo CPU processes with
``--force-host N`` or ``--device cpu``. The ranks run on the card unless
``--device cpu`` is given (``--force-host`` is the CPU by definition). The
probes compute in f32, as the fused parity does: their digests are
compared across world sizes.

Usage:
    python -m dotaclient_tpu_torch.utils.run_multichip                   # preflight on the cards
    python -m dotaclient_tpu_torch.utils.run_multichip --force-host 2    # gloo CPU fallback
    python -m dotaclient_tpu_torch.utils.run_multichip --fused-parity 2 [--device cpu]
    python -m dotaclient_tpu_torch.utils.run_multichip --probe --devices 2 --steps 8   # the bench's probe
    python -m dotaclient_tpu_torch.utils.run_multichip --fused --force-host 2
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import tempfile
import time
from typing import Any, Dict, List, Optional, Tuple

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

REMEDY_CPU = "or rerun with --force-host N to validate the data-parallel path on gloo CPU processes"

# Known CUDA/NCCL initialization failure shapes → (reason, remediation).
# Matched against the output of the init only (the card's init child, the
# ranks that never joined their world); the first hit wins. Data-driven,
# so the next broken-environment shape is one tuple.
FAILURE_SIGNATURES: Tuple[Tuple[str, str, str], ...] = (
    (
        "CUDA driver version is insufficient",
        "the NVIDIA driver is older than the CUDA runtime this torch was built with",
        "update the driver, or install a torch built for the driver's CUDA version, " + REMEDY_CPU,
    ),
    (
        "Found no NVIDIA driver",
        "no NVIDIA driver on this machine",
        "install the NVIDIA driver (nvidia-smi must list the card), " + REMEDY_CPU,
    ),
    (
        "no CUDA-capable device is detected",
        "no CUDA device is visible to this process",
        "check nvidia-smi and CUDA_VISIBLE_DEVICES, " + REMEDY_CPU,
    ),
    (
        "Torch not compiled with CUDA enabled",
        "this torch is a CPU-only build",
        "install a CUDA build of torch, " + REMEDY_CPU,
    ),
    (
        "busy or unavailable",
        "the card is busy or unavailable (exclusive-process mode, held by another process)",
        "free the card (nvidia-smi lists the processes holding it) or set its compute mode to default, "
        + REMEDY_CPU,
    ),
    (
        "out of memory",
        "the card is out of memory (another process holding it?)",
        "free the card's memory (nvidia-smi lists the processes holding it), " + REMEDY_CPU,
    ),
    (
        "NCCL error",
        "NCCL failed to set up the process group",
        "check NCCL_DEBUG=INFO's output (one card a rank; NCCL refuses two ranks on one card), " + REMEDY_CPU,
    ),
    (
        # emitted by _run_subprocess and _run_world on a timeout: a wedged
        # init (a card held by another process) must classify into the
        # same skip+remediation shape, not escape as a traceback
        "MULTICHIP_PREFLIGHT_TIMEOUT",
        "the card's init or the dry run did not complete within the timeout (another process holding the "
        "card? a rank waiting on a peer that died?)",
        "free the card (nvidia-smi lists the processes holding it), check for stuck processes, " + REMEDY_CPU,
    ),
)

# the parity probe's sizes: the learner's --smoke games at f32 compute, one
# minibatch (the shard-count-invariant program, as the reference's)
PARITY_ENVS, PARITY_STEPS, PARITY_ROLLOUT_LEN = 4, 2, 8
# the dry run's rows a rank and rollout length
DRYRUN_ROWS, DRYRUN_ROLLOUT_LEN = 8, 8
# the probes' timed dispatches a segment (best of 2 segments) and the
# deterministic steps of their digest
PROBE_STEPS, PROBE_PARITY_STEPS = 10, 3
# a rank prints it once it has joined its world: what it printed before is
# its init's output, what fails after is the path's
JOINED = "MULTICHIP_RANK_JOINED"


def classify_backend_error(text: str) -> Optional[Tuple[str, str]]:
    """Map a child's output to (reason, remediation), or None when no known
    signature matches (the caller then reports the tail verbatim: unknown
    breakage must stay visible, just bounded)."""
    for needle, reason, remediation in FAILURE_SIGNATURES:
        if needle in text:
            return reason, remediation
    return None


def _result(payload: dict) -> int:
    print(json.dumps(payload, sort_keys=True))
    return 0 if payload.get("ok") or payload.get("skipped") else 1


def _partial(e: subprocess.TimeoutExpired) -> str:
    return "".join(p.decode(errors="replace") if isinstance(p, bytes) else (p or "") for p in (e.stdout, e.stderr))


def _run_subprocess(code: str, env: Optional[dict] = None, timeout: float = 900.0) -> Tuple[int, str]:
    """Run ``python -c code`` fresh; a hang becomes a classifiable
    MULTICHIP_PREFLIGHT_TIMEOUT marker (rc -1) instead of an uncaught
    TimeoutExpired traceback (a card held by another process commonly
    BLOCKS init rather than erroring)."""
    try:
        proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env={**os.environ, **(env or {})},
                              capture_output=True, text=True, timeout=timeout)
    except subprocess.TimeoutExpired as e:
        return -1, f"MULTICHIP_PREFLIGHT_TIMEOUT after {timeout:.0f}s\n{_partial(e)}"
    return proc.returncode, proc.stdout + proc.stderr


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


World = Tuple[int, str, List[Optional[dict]], str]


def _run_world(world: int, job: str, device: str, backend: str, payload: dict, timeout: float = 900.0) -> World:
    """``job`` (``dryrun`` or ``fused_rank``) on ``world`` fresh processes,
    one rank each, joined over ``backend`` at a localhost port; the
    verdict of ``_world`` on their exit codes and outputs (every rank
    killed on a timeout)."""
    addr = f"127.0.0.1:{_free_port()}"
    env = {**os.environ, "OMP_NUM_THREADS": "1"} if device == "cpu" else dict(os.environ)
    procs, files = [], []
    for rank in range(world):
        code = (f"from dotaclient_tpu_torch.utils.run_multichip import _rank_entry; "
                f"_rank_entry({job!r}, {rank}, {world}, {addr!r}, {device!r}, {backend!r}, {json.dumps(payload)!r})")
        # output into files, not pipes: a rank that writes much cannot
        # block on a pipe nobody reads while another rank is waited for
        files.append(tempfile.TemporaryFile("w+"))
        procs.append(subprocess.Popen([sys.executable, "-c", code], cwd=REPO, env=env, stdout=files[-1],
                                      stderr=subprocess.STDOUT, text=True))
    end = time.monotonic() + timeout
    timed_out = False
    for p in procs:
        try:
            p.wait(timeout=max(0.1, end - time.monotonic()))
        except subprocess.TimeoutExpired:
            timed_out = True
            for q in procs:
                q.kill()
            for q in procs:
                q.wait()
            break
    outs = []
    for f in files:
        f.seek(0)
        outs.append(f.read())
        f.close()
    return _world([p.returncode for p in procs], outs, timed_out, timeout)


def _world(rcs: List[int], outs: List[str], timed_out: bool, timeout: float) -> World:
    """A world's verdict from its ranks' exit codes and outputs: the worst
    exit code (-1 on a timeout), the ranks' combined output, each rank's
    result (None where it printed none), and the output of its init, the
    only text a SKIP is classified from: the ranks that never printed
    ``JOINED``, with the timeout marker when the timeout cut one of them.
    Empty when every rank joined: what failed then is the path's fault."""
    results: List[Optional[dict]] = []
    for out in outs:
        found = [ln for ln in out.splitlines() if ln.startswith("MULTICHIP_RANK ")]
        results.append(json.loads(found[-1][len("MULTICHIP_RANK "):]) if found else None)
    text = "\n".join(f"[rank {r}] {o}" for r, o in enumerate(outs))
    init = "\n".join(f"[rank {r}] {o}" for r, o in enumerate(outs) if JOINED not in o.splitlines())
    if timed_out:
        marker = f"MULTICHIP_PREFLIGHT_TIMEOUT after {timeout:.0f}s\n"
        return -1, marker + text, results, marker + init if init else ""
    return max(rcs, key=abs), text, results, init


def _rank_device(device: str, rank: int):
    import torch

    if device == "cpu":
        return torch.device("cpu")
    return torch.device("cuda", rank % torch.cuda.device_count())


def _rank_entry(job: str, rank: int, world: int, addr: str, device: str, backend: str, payload_json: str) -> None:
    """A rank's process: join the world (the process group, and one
    all-reduce through it, which forms NCCL's communicator), print
    ``JOINED``, run ``job``, print its result as one ``MULTICHIP_RANK
    {json}`` line."""
    import torch
    import torch.distributed as dist

    from dotaclient_tpu_torch.parallel import initialize_runtime

    if device == "cpu":
        torch.set_num_threads(1)
    else:
        torch.cuda.set_device(_rank_device(device, rank))
    initialize_runtime(addr, world, rank, backend=backend, timeout_s=300.0)
    try:
        ones = torch.ones(1, device=_rank_device(device, rank))
        dist.all_reduce(ones)
        if int(ones.item()) != world:
            raise AssertionError(f"the join's all-reduce gave {ones.item()}, expected {world}")
        print(JOINED, flush=True)
        jobs = {"dryrun": dryrun, "fused_rank": fused_rank, "probe_rank": probe_rank}
        out = jobs[job](rank, world, device, json.loads(payload_json))
        print("MULTICHIP_RANK " + json.dumps(out, sort_keys=True), flush=True)
    finally:
        dist.destroy_process_group()


def _config(payload: dict):
    """The run config of a rank: the defaults, with ``payload``'s model
    overrides (the tests' tiny widths)."""
    import dataclasses

    from dotaclient_tpu_torch.config import default_config

    config = default_config()
    return dataclasses.replace(config, model=dataclasses.replace(config.model, **payload.get("model", {})))


def _param_l1(policy) -> float:
    import torch

    return float(sum(p.detach().to(torch.float64).abs().sum().item() for p in policy.parameters()))


def _launches() -> int:
    from dotaclient_tpu_torch.ops import lstm

    return lstm.lstm_sequence_kernel.launches


def dryrun(rank: int, world: int, device: str, payload: dict) -> Dict[str, Any]:
    """One data-parallel update of a seeded global batch of ``DRYRUN_ROWS``
    rows a rank: this rank's rows through the step over the mesh's batch
    group, the global batch's update on every rank."""
    import dataclasses

    import numpy as np
    import torch

    from dotaclient_tpu_torch.bench import seeded_batch
    from dotaclient_tpu_torch.models.policy import init_params, make_policy
    from dotaclient_tpu_torch.parallel import make_mesh
    from dotaclient_tpu_torch.parallel.mesh import data_sharding
    from dotaclient_tpu_torch.train.ppo import init_train_state, make_train_step
    from dotaclient_tpu_torch.utils.tree import tree_map

    config = _config(payload)
    B = DRYRUN_ROWS * world
    config = dataclasses.replace(config, ppo=dataclasses.replace(config.ppo, rollout_len=DRYRUN_ROLLOUT_LEN,
                                                                 batch_rollouts=B))
    dev = _rank_device(device, rank)
    mesh = make_mesh(config.mesh)
    policy = make_policy(config.model, config.obs, config.actions, device=dev)
    init_params(policy, torch.Generator().manual_seed(0))
    state = init_train_state(policy, config.ppo)
    step = make_train_step(config, group=mesh.batch_group if world > 1 else None)
    batch = seeded_batch(config, B, np.random.default_rng(0), dev)
    rows = data_sharding(mesh, config.mesh, B)
    launches0 = _launches()
    state, m = step(state, tree_map(lambda t: t[rows], batch))
    loss = float(m["loss"])
    if not np.isfinite(loss):
        raise AssertionError(f"non-finite loss {loss}")
    return {"loss": loss, "grad_norm": float(m["grad_norm"]), "param_l1": _param_l1(policy),
            "rows": rows.stop - rows.start, "lstm_seq_launches": _launches() - launches0}


def fused_rank(rank: int, world: int, device: str, payload: dict) -> Dict[str, Any]:
    """``parity_steps`` calls of the fused iteration from the seed's params
    with the lane-sharded actor over the world; each call's loss, the
    params' float64 L1 after them, and the lane layout read off the actor's
    state."""
    import dataclasses

    import numpy as np
    import torch

    from dotaclient_tpu_torch.actor.device_rollout import DeviceActor
    from dotaclient_tpu_torch.models.policy import init_params, make_policy
    from dotaclient_tpu_torch.parallel import make_mesh
    from dotaclient_tpu_torch.train.fused import make_fused_step
    from dotaclient_tpu_torch.train.ppo import init_train_state

    config = _config(payload)
    config = dataclasses.replace(
        config,
        model=dataclasses.replace(config.model, dtype="float32"),
        env=dataclasses.replace(config.env, n_envs=PARITY_ENVS, max_dota_time=60.0),
        ppo=dataclasses.replace(config.ppo, rollout_len=payload["rollout_len"],
                                minibatches=1, epochs_per_batch=1),
    )
    dev = _rank_device(device, rank)
    mesh = make_mesh(config.mesh)
    policy = make_policy(config.model, config.obs, config.actions, device=dev)
    init_params(policy, torch.Generator().manual_seed(config.seed))
    state = init_train_state(policy, config.ppo)
    actor = DeviceActor(config, policy, seed=config.seed, device=dev, mesh=mesh)
    fused = make_fused_step(config, actor)
    launches0 = _launches()
    ast, losses = actor.state, []
    for _ in range(payload["parity_steps"]):
        state, ast, m, _stats = fused(state, ast)
        loss = float(m["loss"])
        if not np.isfinite(loss):
            raise AssertionError(f"non-finite loss {loss}")
        losses.append(loss)
    out = {"losses": losses, "param_l1": _param_l1(policy), "lane_shards": int(actor.lane_shards),
           "global_lanes": int(actor._global_lanes), "state_lane_rows": int(ast.ep_return.shape[0])}
    steps = payload.get("steps", 0)
    if steps:
        # after the digest: a settling call, then the best of 2 segments
        # (every lane of the world trained a call)
        frames = actor._global_lanes * config.ppo.rollout_len * config.steps_per_dispatch

        def run(n):
            nonlocal state, ast
            for _ in range(n):
                state, ast, m, _stats = fused(state, ast)
            return float(m["loss"])

        out["optimizer_frames_per_sec"] = _best_fps(run, steps, frames)
    out["lstm_seq_launches"] = _launches() - launches0
    return out


def _best_fps(run, steps: int, frames: int) -> float:
    """``run(1)`` to settle, then the best of 2 segments of ``run(steps)``
    in ``frames`` a step over the host clock; ``run`` reads a result of its
    last step, so each segment ends when the device has finished it."""
    run(1)
    fps = 0.0
    for _ in range(2):
        t0 = time.perf_counter()
        run(steps)
        fps = max(fps, steps * frames / (time.perf_counter() - t0))
    return round(fps, 1)


def _probe_config(payload: dict):
    """The probe's run config: the default shapes with E=2 and M=2 (the
    multi-update program), f32 compute, ``payload``'s DCN slices and model
    overrides."""
    import dataclasses

    config = _config(payload)
    return dataclasses.replace(
        config,
        model=dataclasses.replace(config.model, dtype="float32"),
        ppo=dataclasses.replace(config.ppo, epochs_per_batch=2, minibatches=2),
        mesh=dataclasses.replace(config.mesh, dcn_slices=payload.get("dcn_slices", 1)),
    )


def probe_rank(rank: int, world: int, device: str, payload: dict) -> Dict[str, Any]:
    """The epoch step over the world's batch group: ``parity_steps`` steps
    from the seed's params (each loss, then the params' float64 L1), then
    the throughput of fresh params: a settling step and the best of 2
    segments of ``steps``, in global frames over the host clock. The
    batch is the reference probe's seeded one; the permutations are drawn
    from the learner's stream (``seed + 1``), the same on every rank."""
    import numpy as np
    import torch

    from dotaclient_tpu_torch.bench import seeded_batch
    from dotaclient_tpu_torch.models.policy import init_params, make_policy
    from dotaclient_tpu_torch.parallel import make_mesh
    from dotaclient_tpu_torch.parallel.mesh import data_sharding
    from dotaclient_tpu_torch.train.ppo import init_train_state, make_epoch_step
    from dotaclient_tpu_torch.utils.tree import tree_map

    config = _probe_config(payload)
    B, T, E = config.ppo.batch_rollouts, config.ppo.rollout_len, config.ppo.epochs_per_batch
    dev = _rank_device(device, rank)
    mesh = make_mesh(config.mesh)
    policy = make_policy(config.model, config.obs, config.actions, device=dev)
    step = make_epoch_step(config, group=mesh.batch_group if world > 1 else None)

    def fresh_state():
        init_params(policy, torch.Generator().manual_seed(config.seed))
        return init_train_state(policy, config.ppo)

    batch = seeded_batch(config, B, np.random.default_rng(0), dev)
    batch = tree_map(lambda t: t[data_sharding(mesh, config.mesh, B)], batch)
    mb_rng = np.random.default_rng(config.seed + 1)

    def perms():
        return np.stack([mb_rng.permutation(B) for _ in range(E)]).astype(np.int32)

    launches0 = _launches()
    state, losses = fresh_state(), []
    for _ in range(payload["parity_steps"]):
        state, m = step(state, batch, perms())
        losses.append(float(m["loss"]))
    if not all(np.isfinite(losses)):
        raise AssertionError(f"non-finite losses {losses}")
    param_l1 = _param_l1(policy)
    state = fresh_state()

    def run(n):
        nonlocal state
        for _ in range(n):
            state, m = step(state, batch, perms())
        return float(m["loss"])

    fps = _best_fps(run, payload["steps"], B * T)
    return {"losses": losses, "param_l1": param_l1, "optimizer_frames_per_sec": fps,
            "mesh": {str(k): int(v) for k, v in mesh.shape.items()},
            "lstm_seq_launches": _launches() - launches0}


def _backend_init_subprocess() -> Tuple[int, str]:
    """Initialize CUDA with no device pin: ``torch.cuda.init()``, the device
    count and one small op on the card are what trip a broken environment."""
    return _run_subprocess(
        "import json, torch; torch.cuda.init(); n = torch.cuda.device_count(); "
        "x = torch.arange(64, dtype=torch.float32, device='cuda'); s = float((x * 2).sum()); "
        "assert s == 4032.0, s; "
        "print('BACKEND ' + json.dumps({'count': n, 'names': [torch.cuda.get_device_name(i) for i in range(n)], "
        "'cuda': torch.version.cuda}))",
        timeout=300.0,
    )


def _skip(payload: dict, out: str) -> Optional[int]:
    """The classified SKIP of a failed init, or None when its output
    matches no known signature (or is empty: no init failed)."""
    classified = classify_backend_error(out)
    if classified is None:
        return None
    reason, remediation = classified
    # the actionable skip: one reason line + one remediation line, never
    # the traceback
    print(f"MULTICHIP SKIP: {reason}", file=sys.stderr)
    print(f"  remediation: {remediation}", file=sys.stderr)
    return _result({**payload, "ok": False, "skipped": True, "reason": reason, "remediation": remediation})


def _dryrun_result(n: int, mode: str, device: str, backend: str, extra: dict, model: dict) -> int:
    rc, out, results, init = _run_world(n, "dryrun", device, backend, {"model": model})
    base = {"n_devices": n, "mode": mode, "backend": backend, **extra, "rc": rc}
    ok = rc == 0 and all(r is not None for r in results)
    if ok:
        l1 = {r["param_l1"] for r in results}
        if len(l1) != 1:
            ok, out = False, out + f"\nthe ranks' params differ after the update: param L1 {sorted(l1)}"
    if not ok:
        if rc != 0:
            skipped = _skip(base, init)
            if skipped is not None:
                return skipped
        return _result({**base, "ok": False, "skipped": False, "tail": "\n".join(out.splitlines()[-12:])})
    r0 = results[0]
    tail = (f"dryrun_multichip ok: world {n} over {backend}, one global-batch update of {DRYRUN_ROWS * n} rows "
            f"({r0['rows']} a rank), loss={r0['loss']:.4f}, params equal on every rank "
            f"(param L1 {r0['param_l1']:.6f})")
    return _result({**base, "ok": True, "skipped": False, "tail": tail,
                    "lstm_seq_launches": sum(r["lstm_seq_launches"] for r in results)})


def preflight(n_devices: Optional[int], force_host: Optional[int], device: str = "cuda",
              model: Optional[dict] = None) -> int:
    """Init the card, then dry-run the data-parallel update; classify a
    broken environment as a SKIP."""
    model = model or {}
    if force_host is not None or device == "cpu":
        n = force_host if force_host is not None else (n_devices or 1)
        return _dryrun_result(n, "forced-host", "cpu", "gloo", {}, model)
    # step 1: the card's init with no pin, the op that trips a broken env
    init_rc, init_out = _backend_init_subprocess()
    base = {"n_devices": n_devices, "mode": "accelerator", "rc": init_rc}
    if init_rc != 0:
        skipped = _skip(base, init_out)
        if skipped is not None:
            return skipped
        return _result({**base, "ok": False, "skipped": False, "tail": "\n".join(init_out.splitlines()[-12:])})
    line = next((ln for ln in init_out.splitlines() if ln.startswith("BACKEND ")), "BACKEND {}")
    backend_info = json.loads(line[len("BACKEND "):])
    count = int(backend_info.get("count", 0))
    n = n_devices if n_devices is not None else count
    # step 2: the dry run, over NCCL when every rank has a card of its own
    backend = "nccl" if n <= count else "gloo"
    return _dryrun_result(n, "accelerator", "cuda", backend, {"backend_info": backend_info}, model)


def _measure(job: str, mode: str, n_devices: Optional[int], force_host: Optional[int], device: str,
             payload: dict) -> Tuple[Optional[int], Optional[dict], List[dict]]:
    """``job`` on the preflight's world: ``force_host`` (or ``n_devices``
    with ``device="cpu"``) gloo CPU processes, else ``n_devices`` ranks
    (default: the card count) on the cards, over NCCL when each has its
    own. Returns (None, the result's base, each rank's result), or (the
    exit code of the printed SKIP or failure line, None, [])."""
    if force_host is not None or device == "cpu":
        n, device, backend = (force_host if force_host is not None else (n_devices or 1)), "cpu", "gloo"
    else:
        import torch

        count = torch.cuda.device_count()
        n = n_devices if n_devices is not None else max(1, count)
        backend = "nccl" if n <= count else "gloo"
    rc, out, results, init = _run_world(n, job, device, backend, payload)
    base = {"n_devices": n, "mode": mode, "backend": backend, "device": device, "rc": rc}
    if rc == 0 and all(r is not None for r in results):
        l1 = {r["param_l1"] for r in results}
        if len(l1) == 1:
            return None, base, results
        out += f"\nthe ranks' params differ after the digest: param L1 {sorted(l1)}"
    skipped = _skip(base, init) if rc != 0 else None
    if skipped is not None:
        return skipped, None, []
    return _result({**base, "ok": False, "skipped": False, "tail": "\n".join(out.splitlines()[-12:])}), None, []


def probe(n_devices: Optional[int], force_host: Optional[int] = None, device: str = "cuda",
          steps: int = PROBE_STEPS, parity_steps: int = PROBE_PARITY_STEPS, dcn_slices: int = 1,
          model: Optional[dict] = None) -> int:
    """``--probe``: the epoch step's optimizer frames/s and parity digest at
    world N (rank 0's numbers; every rank's params equal after the
    digest)."""
    payload = {"model": model or {}, "steps": steps, "parity_steps": parity_steps, "dcn_slices": dcn_slices}
    rc, base, results = _measure("probe_rank", "probe", n_devices, force_host, device, payload)
    if base is None:
        return rc
    r0 = results[0]
    return _result({**base, "ok": True, "skipped": False, "mesh": r0["mesh"],
                    "optimizer_frames_per_sec": r0["optimizer_frames_per_sec"],
                    "parity": {"losses": r0["losses"], "param_l1": r0["param_l1"]},
                    "lstm_seq_launches": sum(r["lstm_seq_launches"] for r in results)})


def fused_probe(n_devices: Optional[int], force_host: Optional[int] = None, device: str = "cuda",
                steps: int = PROBE_STEPS, parity_steps: int = PROBE_PARITY_STEPS,
                rollout_len: int = PARITY_ROLLOUT_LEN, model: Optional[dict] = None) -> int:
    """``--fused``: the fused iteration's optimizer frames/s, parity digest
    and lane layout at world N (rank 0's numbers)."""
    payload = {"model": model or {}, "steps": steps, "parity_steps": parity_steps, "rollout_len": rollout_len}
    rc, base, results = _measure("fused_rank", "fused", n_devices, force_host, device, payload)
    if base is None:
        return rc
    r0, n = results[0], base["n_devices"]
    return _result({**base, "ok": True, "skipped": False, "lane_shards": r0["lane_shards"],
                    "lanes_per_shard": r0["state_lane_rows"], "n_lanes": r0["global_lanes"],
                    "lane_sharded": n > 1 and all(r["lane_shards"] == n and r["state_lane_rows"] * n
                                                  == r["global_lanes"] for r in results),
                    "optimizer_frames_per_sec": r0["optimizer_frames_per_sec"],
                    "parity": {"losses": r0["losses"], "param_l1": r0["param_l1"]},
                    "lstm_seq_launches": sum(r["lstm_seq_launches"] for r in results)})


def fused_parity(n_high: int, parity_steps: int = PARITY_STEPS, rollout_len: int = PARITY_ROLLOUT_LEN,
                 device: str = "cuda", model: Optional[dict] = None, steps: int = 0) -> int:
    """One-command parity verdict: the fused iteration at world 1 and world
    ``n_high`` (fresh processes each, gloo: the ranks may share a card),
    compared at reassociation tolerance, with the lane-sharding proof.

    * per-dispatch losses at ``|a-b| <= max(1e-3, 2e-2·|a|)``: each dispatch
      crosses Adam updates whose gradient sum reassociates over the ranks,
      and Adam's ``1/(sqrt(v)+eps)`` amplifies those deltas on near-zero
      gradient coordinates (the reference's tolerance);
    * the float64 param L1 at ``|c1-cN| <= 1e-5·max(1, |c1|)``;
    * at ``n_high``: every rank's actor state holds ``lanes / n_high`` rows
      (``lane_shards == n_high``), read off the state.

    With ``steps`` each world also times its fused calls after the digest
    (``--fused``'s measurement), and the line carries
    ``scaling_efficiency``, ``(fps_N / fps_1) / N``.
    """
    payload = {"model": model or {}, "parity_steps": parity_steps, "rollout_len": rollout_len, "steps": steps}
    probes: Dict[int, List[dict]] = {}
    for n in (1, n_high):
        rc, out, results, init = _run_world(n, "fused_rank", device, "gloo", payload)
        if rc != 0 or any(r is None for r in results):
            base = {"mode": "fused-parity", "n_devices": n_high}
            skipped = _skip(base, init) if rc != 0 else None
            if skipped is not None:
                return skipped
            return _result({**base, "ok": False, "skipped": False, "failed_probe_devices": n, "rc": rc,
                            "tail": "\n".join(out.splitlines()[-12:])})
        probes[n] = results
    one, high = probes[1][0], probes[n_high]
    l1, ln = one["losses"], high[0]["losses"]
    c1, cn = one["param_l1"], high[0]["param_l1"]
    losses_ok = all(r["losses"] == ln for r in high) and len(l1) == len(ln) and all(
        abs(a - b) <= max(1e-3, 2e-2 * abs(a)) for a, b in zip(l1, ln))
    checksum_ok = all(r["param_l1"] == cn for r in high) and abs(c1 - cn) <= 1e-5 * max(1.0, abs(c1))
    lane_sharded = all(r["lane_shards"] == n_high and r["state_lane_rows"] * n_high == r["global_lanes"]
                       for r in high)
    extra = {}
    if steps:
        fps1, fpsn = one["optimizer_frames_per_sec"], high[0]["optimizer_frames_per_sec"]
        extra["scaling_efficiency"] = round(fpsn / (fps1 * n_high), 4) if fps1 > 0 else 0.0
    return _result({
        **extra,
        "mode": "fused-parity",
        "n_devices": n_high,
        "rc": 0,
        "ok": losses_ok and checksum_ok and lane_sharded,
        "skipped": False,
        "devices": [1, n_high],
        "device": device,
        "parity": {"losses_ok": losses_ok, "param_l1_ok": checksum_ok,
                   "max_abs_loss_diff": max((abs(a - b) for a, b in zip(l1, ln)), default=float("inf")),
                   "param_l1": [c1, cn]},
        "lane_sharded": lane_sharded,
        "lanes": {"global": one["global_lanes"], "per_rank": [r["state_lane_rows"] for r in high]},
        "lstm_seq_launches": one["lstm_seq_launches"] + sum(r["lstm_seq_launches"] for r in high),
        "probes": {"1": one, str(n_high): high},
    })


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--devices", type=int, default=None,
                   help="preflight and probes: the world size (default: the card count)")
    p.add_argument("--force-host", type=int, default=None, metavar="N",
                   help="skip the card and run the dry run (or a probe) on N gloo CPU processes: the zero-GPU "
                   "validation path")
    p.add_argument("--probe", action="store_true",
                   help="measurement mode (the bench's multichip stage): the epoch step's optimizer frames/s and "
                   "parity digest at world N")
    p.add_argument("--fused", action="store_true",
                   help="measurement mode for the fused iteration (rollout + update, actor='fused'): lane-sharded "
                   "frames/s, parity digest and the lane-sharding proof at world N")
    p.add_argument("--fused-parity", type=int, default=None, metavar="N",
                   help="one-command verdict: the fused iteration at world 1 and world N (fresh processes, gloo), "
                   "compared at reassociation tolerance, with the lane-sharding proof at N")
    p.add_argument("--device", type=str, default="cuda", choices=("cuda", "cpu"),
                   help="where the ranks run (default the card; 'cpu' must be asked for)")
    p.add_argument("--dcn-slices", type=int, default=1,
                   help="--probe: build the (dcn, data, model) mesh with this many DCN slices (the world must "
                   "divide by dcn_slices x model_parallel)")
    p.add_argument("--steps", type=int, default=None,
                   help=f"timed calls a segment: --probe and --fused (default {PROBE_STEPS}); --fused-parity "
                   "(default 0: no timing)")
    p.add_argument("--parity-steps", type=int, default=None,
                   help=f"calls in the parity digest (default {PROBE_PARITY_STEPS} for the probes, {PARITY_STEPS} "
                   "for --fused-parity)")
    p.add_argument("--rollout-len", type=int, default=PARITY_ROLLOUT_LEN,
                   help="--fused and --fused-parity: rollout chunk length T of the probe")
    args = p.parse_args(argv)
    if args.fused_parity is not None:
        return fused_parity(args.fused_parity, args.parity_steps or PARITY_STEPS, args.rollout_len, args.device,
                            steps=args.steps or 0)
    probe_args = dict(force_host=args.force_host, device=args.device,
                      steps=PROBE_STEPS if args.steps is None else args.steps,
                      parity_steps=args.parity_steps or PROBE_PARITY_STEPS)
    if args.fused:
        return fused_probe(args.devices, rollout_len=args.rollout_len, **probe_args)
    if args.probe:
        return probe(args.devices, dcn_slices=args.dcn_slices, **probe_args)
    return preflight(args.devices, args.force_host, args.device)


if __name__ == "__main__":
    sys.exit(main())
