#!/usr/bin/env python3
"""Drive the PyTorch port's serving path on one NVIDIA card, end to end.

Run from the root of a checkout, on a machine with a CUDA card:

    python3 chip_smoke.py [--seed 0] [--out results.json]

Phases (any failure exits non-zero and prints no result line):

1. build: compile every kernel of the path (``ops/csrc/*.cu``, sm_90a)
   from the sources in this checkout;
2. kernels: each kernel against its plain PyTorch version on the card, on
   seeded random inputs at every shape the port gives it (for the LSTM:
   the serving step B=64 T=1, the learner's sequence B=32 T=16, the test
   shape and a batch with a partial row tile), with the f32 tolerance
   stated below, its launch plan logged, and timed on the card (CUDA
   events around a CUDA graph of 100 calls, median of 11 replays; warm)
   beside its plain version, the one PyTorch call that computes the same
   function (``torch.lstm_cell`` at T=1; at T=16 cuDNN's ``torch.lstm`` on
   a reset-free copy, a labelled yardstick only) and its roofline bound;
   the time of a single call with the host's issue included (events
   around each call, median of 200) is logged too;
3. serve: the default ``RunConfig`` (LSTM(128) policy, bf16 compute, f32
   params drawn from ``--seed``; max_batch 64, max_slots 256) served by
   ``ServeEngine`` on the card: 64 games submit 20 steps each (1,280
   requests) with resets at episode starts, 2 slot releases and 1 weight
   swap partway through. Checked: every request answered, every action
   legal under its masks, zero dispatch errors, the first round's log-probs
   against the same policy on the CPU, and a bitwise replay of the whole
   recorded stream through ``reference_step``. The kernels' launch counts
   are reset just before this phase and read just after it;
4. profile: a few more serve rounds under torch.profiler, for the card's
   busy share and the kernels that took its time.

The lines before the last are the ``kernels`` JSON and the card's name and
power limit from nvidia-smi; the last line is the JSON result.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import subprocess
import sys
import time
import traceback

import numpy as np

# Published peaks of one H100 SXM (dense): the roofline bound's rates.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12        # float32 outside the tensor cores

KERNEL_ATOL = 1e-5            # f32 kernel vs plain f32 version on the card
# served log-probs vs the same policy on the CPU: both compute in bf16, and
# cuBLAS and the CPU round bf16 products and sums in their own order; a
# few bf16 ulps at logits of magnitude ~1 stay well inside this
SERVE_LOGP_ATOL = 0.1

N_GAMES, N_STEPS = 64, 20
RELEASE_AFTER_ROUND, RELEASED_SLOTS = 7, (3, 40)
SWAP_AFTER_ROUND = 11


def log(msg: str) -> None:
    print(f"[chip_smoke] {msg}", flush=True)


def time_ms(fn, n: int = 200, warmup: int = 20) -> float:
    """Median time of one call of ``fn`` in ms as a caller sees it: CUDA
    events around each single call, so the host's work to issue it counts
    wherever the card would otherwise wait for it."""
    import torch

    for _ in range(warmup):
        fn()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(n)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(n)]
    for s, e in zip(starts, ends):
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in zip(starts, ends))


def device_ms(fn, n: int = 100, reps: int = 11) -> float:
    """Device time of one call of ``fn`` in ms, host issue excluded: ``n``
    calls captured in one CUDA graph, the graph replayed ``reps`` times
    between CUDA events, the median replay divided by ``n``."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / n)
    return statistics.median(times)


# -- phase 2: the LSTM kernel against its plain version ----------------------


def lstm_inputs(B, T, D, H, seed, device):
    import torch

    g = torch.Generator().manual_seed(seed)
    f = lambda *s: (torch.randn(*s, generator=g) * 0.3).to(device)
    resets = (torch.rand(B, T, generator=g) < 0.2).float().to(device)
    return (f(B, T, D), f(B, H), f(B, H), f(D, 4 * H), f(H, 4 * H), f(4 * H), resets)


def lstm_bound(B, T, D, H):
    """(least time in ms, what bounds it) for the function: each input read
    once and each output written once at the memory rate, or its gate
    multiply-adds and bias adds at the f32 rate, whichever is larger."""
    G = 4 * H
    n_bytes = 4 * (B * T * D + 2 * B * H + D * G + H * G + G + B * T + B * T * H + 2 * B * H)
    flops = 2 * B * T * (D + H) * G + B * T * G
    t_bytes, t_ops = n_bytes / PEAK_BYTES_PER_S, flops / PEAK_F32_FLOPS
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


# (B, T, D, H): the serving step, the learner's sequence, the small test
# shape, and a batch that leaves one partial row tile
LSTM_SHAPES = ((64, 1, 128, 128), (32, 16, 128, 128), (5, 3, 16, 32), (65, 2, 128, 128))


def max_err(got, want):
    return max(float((a - b).abs().max()) for a, b in zip((got[0], *got[1]), (want[0], *want[1])))


def lstm_cell_library(args):
    """The serving step's function in one PyTorch call: torch.lstm_cell
    (gate order i, f, g, o) on the reset-masked carry."""
    import torch

    x, h0, c0, wx, wh, b, r = args
    keep = (1.0 - r[:, 0])[:, None]
    w_ih, w_hh = wx.t().contiguous(), wh.t().contiguous()
    zero_b = torch.zeros_like(b)
    return lambda: torch.lstm_cell(x[:, 0], (h0 * keep, c0 * keep), w_ih, w_hh, b, zero_b)


def lstm_reset_free_library(args):
    """A labelled yardstick for T > 1, not the kernel's function: cuDNN's
    torch.lstm on a reset-free copy of the inputs. No single PyTorch call
    computes the reset-masked sequence. Returns (call, its max abs error
    against the plain version on the same reset-free inputs)."""
    import torch

    from dotaclient_tpu_torch.ops import lstm

    x, h0, c0, wx, wh, b, r = args
    D, H = wx.shape[0], h0.shape[1]
    free = torch.zeros_like(r)
    mod = torch.nn.LSTM(D, H, batch_first=True).to(x.device)
    with torch.no_grad():
        mod.weight_ih_l0.copy_(wx.t())
        mod.weight_hh_l0.copy_(wh.t())
        mod.bias_ih_l0.copy_(b)
        mod.bias_hh_l0.zero_()
    mod.flatten_parameters()
    hx = (h0[None].contiguous(), c0[None].contiguous())

    def call():
        with torch.no_grad():
            return mod(x, hx)

    out, (hT, cT) = call()
    want = lstm.lstm_sequence_reference(x, h0, c0, wx, wh, b, free)
    return call, max_err((out, (hT[0], cT[0])), want)


def check_lstm_kernel(device, seed):
    """Kernel vs plain version at every shape of LSTM_SHAPES, each timed on
    the card with its plan logged; returns the kernels line's entry (the
    serving step's numbers, the worst error of all shapes, the sequence's
    time) and every shape's numbers."""
    import torch

    from dotaclient_tpu_torch.ops import lstm

    shapes = {}
    for B, T, D, H in LSTM_SHAPES:
        plan = lstm.kernel_plan(B, T, D, H)
        args = lstm_inputs(B, T, D, H, seed + B + T, device)
        got = lstm.lstm_sequence_kernel(*args)
        torch.cuda.synchronize()
        want = lstm.lstm_sequence_reference(*args)
        err = max_err(got, want)
        if not err <= KERNEL_ATOL:
            raise AssertionError(f"lstm_seq B={B} T={T} D={D} H={H}: max abs err {err} > {KERNEL_ATOL}")
        bound, bound_by = lstm_bound(B, T, D, H)
        shape = {"B": B, "T": T, "D": D, "H": H, "plan": dataclasses.asdict(plan), "max_abs_err": err,
                 "ms": device_ms(lambda: lstm.lstm_sequence_kernel(*args)),
                 "plain_ms": device_ms(lambda: lstm.lstm_sequence_reference(*args)),
                 "bound_ms": bound, "bound_by": bound_by}
        if (B, T) == (64, 1):
            library = lstm_cell_library(args)
            lib_h, lib_c = library()
            lib_err = max(float((lib_h - want[1][0]).abs().max()), float((lib_c - want[1][1]).abs().max()))
            log(f"torch.lstm_cell vs plain version: max abs err {lib_err:.3g}")
            shape["library_ms"] = device_ms(library)
            shape["call_ms"] = time_ms(lambda: lstm.lstm_sequence_kernel(*args))
        if (B, T) == (32, 16):
            reset_free, rf_err = lstm_reset_free_library(args)
            log(f"torch.lstm (cuDNN, reset-free copy) vs plain version on the same copy: max abs err {rf_err:.3g}")
            shape["library_ms_reset_free"] = device_ms(reset_free)
        log(
            f"lstm_seq B={B} T={T} D={D} H={H}: plan cluster {plan.cluster}, rows per tile {plan.rows}, "
            f"{plan.grid} blocks of {plan.threads} threads, {plan.smem_bytes} B shared memory each; "
            f"max abs err {err:.3g} (atol {KERNEL_ATOL}); kernel {shape['ms'] * 1e3:.2f} us on the card, "
            f"plain {shape['plain_ms'] * 1e3:.2f} us, bound {bound * 1e3:.3f} us by {bound_by}"
            + (f", torch.lstm_cell {shape['library_ms'] * 1e3:.2f} us, "
               f"{shape['call_ms'] * 1e3:.2f} us a call with the host's issue" if "library_ms" in shape else "")
            + (f", torch.lstm reset-free {shape['library_ms_reset_free'] * 1e3:.2f} us"
               if "library_ms_reset_free" in shape else "")
        )
        shapes[(B, T)] = shape
    serve, sequence = shapes[(64, 1)], shapes[(32, 16)]
    entry = {
        "name": "lstm_seq",
        "route": "cuda",
        "source": "dotaclient_tpu_torch/ops/csrc/lstm_seq.cu",
        "replaces": "dotaclient_tpu/ops/pallas/lstm.py:112",
        "launches": 0,
        "max_abs_err": max(s["max_abs_err"] for s in shapes.values()),
        "ms": serve["ms"],
        "plain_ms": serve["plain_ms"],
        "bound_ms": serve["bound_ms"],
        "bound_by": serve["bound_by"],
        "library_ms": serve["library_ms"],
        "plan": serve["plan"],
        "sequence_ms": sequence["ms"],
    }
    return entry, {"sequence": sequence, "shapes": list(shapes.values())}


def lstm_sweep(device, seed):
    """Where the kernel's time goes: its device time at B=32 over T (the
    slope is the cost of one step, the intercept the launch, weight load
    and epilogue), at T=1 over B (one cluster to a full card), and the
    device time of the smallest PyTorch kernel timed the same way (the
    floor that any launch in a stream pays)."""
    import torch

    from dotaclient_tpu_torch.ops import lstm

    D = H = 128
    by_t = {}
    for T in (1, 2, 4, 8, 16, 32):
        args = lstm_inputs(32, T, D, H, seed + T, device)
        by_t[T] = device_ms(lambda: lstm.lstm_sequence_kernel(*args))
    by_b = {}
    for B in (4, 16, 64, 128):
        args = lstm_inputs(B, 1, D, H, seed + B, device)
        by_b[B] = device_ms(lambda: lstm.lstm_sequence_kernel(*args))
    one = torch.zeros(1, device=device)
    floor_ms = device_ms(lambda: one.add_(1.0))
    slope, intercept = np.polyfit(list(by_t), list(by_t.values()), 1)
    log(
        "lstm_seq sweep: B=32 by T "
        + ", ".join(f"T={t} {v * 1e3:.2f}" for t, v in by_t.items())
        + f" us -> {slope * 1e3:.3f} us a step + {intercept * 1e3:.2f} us; T=1 by B "
        + ", ".join(f"B={b} {v * 1e3:.2f}" for b, v in by_b.items())
        + f" us; smallest PyTorch kernel {floor_ms * 1e3:.2f} us"
    )
    return {"B32_ms_by_T": by_t, "ms_per_step": float(slope), "intercept_ms": float(intercept),
            "T1_ms_by_B": by_b, "launch_floor_ms": floor_ms}


# -- phase 3: serve -----------------------------------------------------------


def synthetic_obs(cfg, rng):
    """One plausible observation: some padded units, random legality masks
    with at least one legal action type."""
    o, a = cfg.obs, cfg.actions
    U = o.max_units
    unit_mask = rng.random(U) < 0.75
    unit_mask[0] = True
    mask_action_type = rng.random(a.n_action_types) < 0.7
    mask_action_type[rng.integers(a.n_action_types)] = True
    return {
        "units": rng.normal(size=(U, o.unit_features)).astype(np.float32),
        "unit_mask": unit_mask,
        "unit_handles": rng.integers(0, U, size=U).astype(np.int32),
        "globals": rng.normal(size=o.global_features).astype(np.float32),
        "hero_id": np.asarray(rng.integers(0, cfg.model.n_hero_ids), np.int32),
        "mask_action_type": mask_action_type,
        "mask_target_unit": rng.random(a.max_units) < 0.5,
        "mask_cast_target": rng.random(a.max_units) < 0.3,
        "mask_ability": rng.random(a.max_abilities) < 0.6,
    }


def action_is_legal(obs, packed) -> bool:
    """Legal under the masks, with the all-illegal-row rule of the
    distribution (such a row is sampled as if all-legal)."""
    a_type, move_x, move_y, target, ability = (int(v) for v in packed)

    def ok(mask, i):
        mask = np.asarray(mask)
        return 0 <= i < mask.size and (mask[i] or not mask.any())

    if not ok(obs["mask_action_type"], a_type):
        return False
    if not (0 <= move_x < 9 and 0 <= move_y < 9):
        return False
    if a_type in (2, 3):
        tmask = obs["mask_cast_target"] if a_type == 3 else obs["mask_target_unit"]
        if not ok(tmask, target):
            return False
    if a_type == 3 and not ok(obs["mask_ability"], ability):
        return False
    return True


class Replies:
    def __init__(self):
        import threading

        self.cond = threading.Condition()
        self.items = []

    def __call__(self, actions, logp, version, request_id, dispatch_idx):
        t = time.perf_counter()
        with self.cond:
            self.items.append((request_id, dispatch_idx, version, np.asarray(actions).copy(), logp, t))
            self.cond.notify_all()

    def wait(self, n, timeout=120.0):
        with self.cond:
            if not self.cond.wait_for(lambda: len(self.items) >= n, timeout=timeout):
                raise AssertionError(f"only {len(self.items)}/{n} replies arrived")


def run_games(engine, cfg, rng, params2, n_games, n_steps, release_round):
    """Lockstep rounds: each round every game submits one step and all
    replies arrive before the next. Returns the requests, the replies and
    the rounds after which slots were released."""
    replies = Replies()
    requests = {}
    ep_left = rng.integers(4, 12, size=n_games)
    releases = {}
    for r in range(n_steps):
        if r == release_round:
            for slot in RELEASED_SLOTS:
                engine.release_slot(slot)
            releases[r] = RELEASED_SLOTS
        if r == SWAP_AFTER_ROUND:
            engine.submit_weights(1, params2)
        # the round's observations are made first, so the 64 submits land
        # inside one batch window as concurrent games' requests would
        round_obs = [synthetic_obs(cfg, rng) for _ in range(n_games)]
        for g in range(n_games):
            # a new game takes over each released slot WITHOUT a reset:
            # only the release's zeroing makes its carry fresh
            reset = r == 0 or ep_left[g] == 0
            if reset:
                ep_left[g] = rng.integers(4, 12)
            ep_left[g] -= 1
            if r == release_round and g in RELEASED_SLOTS:
                reset = False
            rid = r * n_games + g
            requests[rid] = (round_obs[g], g, 1.0 if reset else 0.0, time.perf_counter())
            engine.submit(g, round_obs[g], reset=reset, reply=replies, request_id=rid)
        replies.wait((r + 1) * n_games)
    return requests, replies.items, releases


def replay(engine, requests, replies, releases, n_games, params_by_version):
    """Replay every dispatch through ``reference_step`` on a carry store of
    our own; the actions and log-probs must be bitwise those served."""
    import torch

    by_dispatch = {}
    for rid, idx, version, actions, logp, _ in replies:  # arrival = row order
        by_dispatch.setdefault(idx, []).append((rid, version, actions, logp))
    first_dispatch_of_round = {}
    for idx in sorted(by_dispatch):
        first_dispatch_of_round.setdefault(by_dispatch[idx][0][0] // n_games, idx)
    carries = engine.initial_carries()
    mismatches = 0
    for idx in sorted(by_dispatch):
        rows = by_dispatch[idx]
        rnd = rows[0][0] // n_games
        if first_dispatch_of_round.get(rnd) == idx and rnd in releases:
            slots = torch.as_tensor(releases[rnd], device=carries[0].device)
            for c in carries:
                c.index_fill_(0, slots, 0)
        versions = {v for _, v, _, _ in rows}
        if len(versions) != 1:
            raise AssertionError(f"dispatch {idx} mixed weights versions {versions}")
        reqs = [requests[rid] for rid, _, _, _ in rows]
        packed, logp, carries = engine.reference_step(
            [q[0] for q in reqs], [q[1] for q in reqs], [q[2] for q in reqs], carries, idx,
            params=params_by_version[versions.pop()],
        )
        for i, (_, _, actions, lp) in enumerate(rows):
            if not (np.array_equal(packed[i], actions) and float(logp[i]) == lp):
                mismatches += 1
    return mismatches, len(by_dispatch)


def check_first_round_on_cpu(cfg, params, requests, replies, n_games):
    """The first round (all rows fresh) through the same policy on the CPU:
    served log-probs of the served actions within SERVE_LOGP_ATOL."""
    import torch

    from dotaclient_tpu_torch.models import distributions as D
    from dotaclient_tpu_torch.serve import make_inference_policy

    policy = make_inference_policy(cfg, device="cpu")
    policy.load_state_dict(params)
    first = sorted((r for r in replies if r[0] < n_games), key=lambda r: r[0])
    obs = {
        k: torch.from_numpy(np.stack([np.asarray(requests[r[0]][0][k]) for r in first]))
        for k in requests[0][0]
    }
    actions = {h: torch.tensor([int(r[3][i]) for r in first]) for i, h in enumerate(D.HEADS)}
    with torch.no_grad():
        logits, _, _ = policy.step(obs, policy.initial_state(len(first)))
        ref = D.log_prob(logits, obs, actions).numpy()
    served = np.asarray([r[4] for r in first], np.float32)
    return float(np.abs(ref - served).max())


def serve_phase(device, seed):
    import torch

    from dotaclient_tpu_torch.config import RunConfig
    from dotaclient_tpu_torch.models import convert, random_flax_params
    from dotaclient_tpu_torch.ops import lstm
    from dotaclient_tpu_torch.serve import ServeEngine, make_inference_policy
    from dotaclient_tpu_torch.utils import telemetry

    cfg = RunConfig()
    params = convert(random_flax_params(cfg, seed, value_head=False))
    params2 = convert(random_flax_params(cfg, seed + 1, value_head=False))

    # warm-up on an engine of its own (first cuBLAS calls, allocator)
    warm = ServeEngine(cfg, make_inference_policy(cfg, device=device), params,
                       registry=telemetry.Registry(), device=device)
    run_games(warm, cfg, np.random.default_rng(seed + 100), params2, N_GAMES, 2, release_round=-1)
    warm.stop()

    reg = telemetry.Registry()
    engine = ServeEngine(cfg, make_inference_policy(cfg, device=device), params,
                         registry=reg, device=device)
    rng = np.random.default_rng(seed)
    torch.cuda.synchronize()
    lstm.lstm_sequence_kernel.launches = 0
    t0 = time.perf_counter()
    requests, replies, releases = run_games(
        engine, cfg, rng, params2, N_GAMES, N_STEPS, release_round=RELEASE_AFTER_ROUND
    )
    wall = time.perf_counter() - t0
    launches = lstm.lstm_sequence_kernel.launches
    engine.stop()
    snap = reg.snapshot()

    n = N_GAMES * N_STEPS
    if len(replies) != n or len({r[0] for r in replies}) != n:
        raise AssertionError(f"{len(replies)} replies for {n} requests")
    if snap["serve/dispatch_errors_total"] != 0:
        raise AssertionError(f"serve/dispatch_errors_total = {snap['serve/dispatch_errors_total']}")
    illegal = [r[0] for r in replies if not action_is_legal(requests[r[0]][0], r[3])]
    if illegal:
        raise AssertionError(f"{len(illegal)} illegal actions, e.g. request {illegal[0]}")
    if not all(np.isfinite(r[4]) for r in replies):
        raise AssertionError("non-finite log-prob in a reply")
    if snap["serve/weight_swaps_total"] != 1 or {r[2] for r in replies} != {0, 1}:
        raise AssertionError("the weight swap did not land")
    dispatches = int(snap["serve/dispatches_total"])
    if launches != dispatches:
        raise AssertionError(f"{launches} kernel launches for {dispatches} dispatches")
    cpu_err = check_first_round_on_cpu(cfg, params, requests, replies, N_GAMES)
    if not cpu_err <= SERVE_LOGP_ATOL:
        raise AssertionError(f"served log-probs vs CPU policy: {cpu_err} > {SERVE_LOGP_ATOL}")
    mismatches, n_replayed = replay(
        engine, requests, replies, releases, N_GAMES, {0: params, 1: params2}
    )
    if mismatches:
        raise AssertionError(f"reference_step replay: {mismatches} of {n} replies differ")
    lat_ms = np.asarray([(r[5] - requests[r[0]][3]) * 1e3 for r in replies])
    result = {
        "requests": n,
        "replies": len(replies),
        "dispatches": dispatches,
        "mean_batch_fill": n / (dispatches * cfg.serve.max_batch),
        "requests_per_s": n / wall,
        "request_p50_ms": float(np.percentile(lat_ms, 50)),
        "request_p99_ms": float(np.percentile(lat_ms, 99)),
        "dispatch_mean_ms": snap["span/serve/dispatch/mean_s"] * 1e3,
        "dispatch_errors": int(snap["serve/dispatch_errors_total"]),
        "replay": "bitwise",
        "replayed_dispatches": n_replayed,
        "first_round_logp_err_vs_cpu": cpu_err,
        "lstm_seq_launches": launches,
    }
    log(
        f"serve: {n} requests, {len(replies)} replies, {dispatches} dispatches, "
        f"mean batch fill {result['mean_batch_fill']:.3f}, {result['requests_per_s']:.0f} req/s, "
        f"request p50 {result['request_p50_ms']:.3f} ms p99 {result['request_p99_ms']:.3f} ms, "
        f"dispatch mean {result['dispatch_mean_ms']:.3f} ms, replay bitwise over {n_replayed} dispatches, "
        f"logp vs CPU {cpu_err:.3g}, lstm_seq launches {launches}"
    )
    return result


def profile_serve(device, seed, rounds: int = 5):
    """A few lockstep rounds on a fresh engine under torch.profiler (after
    a warm-up), reduced to the device's busy share of the wall clock and
    the kernels that took the most device time. Runs after the checked
    serve phase, whose launch counts are already read."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from dotaclient_tpu_torch.config import RunConfig
    from dotaclient_tpu_torch.models import convert, random_flax_params
    from dotaclient_tpu_torch.serve import ServeEngine, make_inference_policy
    from dotaclient_tpu_torch.utils import telemetry

    cfg = RunConfig()
    params = convert(random_flax_params(cfg, seed, value_head=False))
    reg = telemetry.Registry()
    engine = ServeEngine(cfg, make_inference_policy(cfg, device=device), params,
                         registry=reg, device=device)
    run_games(engine, cfg, np.random.default_rng(seed + 200), params, N_GAMES, 2, release_round=-1)
    torch.cuda.synchronize()
    before = reg.snapshot()["serve/dispatches_total"]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_games(engine, cfg, np.random.default_rng(seed + 300), params, N_GAMES, rounds, release_round=-1)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    engine.stop()
    dispatches = reg.snapshot()["serve/dispatches_total"] - before

    def dev_us(evt):
        return float(getattr(evt, "self_device_time_total", 0.0) or getattr(evt, "self_cuda_time_total", 0.0))

    # device-side events only: a CPU op's self device time repeats the
    # time of the kernels it launched
    events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    device_us = sum(dev_us(e) for e in events)
    top = sorted(events, key=dev_us, reverse=True)[:12]
    result = {
        "rounds": rounds,
        "dispatches": dispatches,
        "wall_ms": wall_s * 1e3,
        "device_busy_ms": device_us / 1e3 if device_us > 0 else None,
        "device_busy_share": (device_us / 1e6) / wall_s if device_us > 0 else None,
        "top_device_ops": [
            {"name": e.key, "device_us": dev_us(e), "count": e.count} for e in top if dev_us(e) > 0
        ],
    }
    log(
        f"profile: {dispatches:.0f} dispatches in {wall_s * 1e3:.1f} ms wall, device busy "
        + ("not measured" if device_us <= 0 else f"{device_us / 1e3:.2f} ms ({result['device_busy_share']:.3f})")
    )
    for e in result["top_device_ops"]:
        log(f"  {e['device_us']:10.1f} us  x{e['count']:<5d} {e['name'][:90]}")
    return result


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--out", default=None, help="also write the results to this JSON file")
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        log("FAILED: no CUDA device")
        return 2
    from dotaclient_tpu_torch.ops import build  # the port must sit beside this script

    torch.backends.cuda.matmul.allow_tf32 = False   # plain f32 versions in full f32
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, CUDA {torch.version.cuda}, {smi}")

    t0 = time.perf_counter()
    build.kernel_library(verbose=True)
    build_s = time.perf_counter() - t0
    log(f"build: {build_s:.1f} s")

    lstm_entry, lstm_extra = check_lstm_kernel(device, args.seed)
    lstm_extra["sweep"] = lstm_sweep(device, args.seed)
    serve = serve_phase(device, args.seed)
    lstm_entry["launches"] = serve["lstm_seq_launches"]
    profiled = profile_serve(device, args.seed)

    kernels = {"kernels": [lstm_entry]}
    if args.out:
        with open(args.out, "w") as f:
            json.dump({**kernels, "lstm_seq_extra": lstm_extra, "serve": serve,
                       "build_s": build_s, "card": smi, "profile": profiled}, f, indent=2)
    print(json.dumps(kernels), flush=True)
    print(smi, flush=True)
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Exception:  # noqa: BLE001 - any failed phase fails the run, loudly
        traceback.print_exc()
        log("FAILED")
        sys.exit(1)
