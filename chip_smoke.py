#!/usr/bin/env python3
"""Drive the PyTorch port's serving, training and league paths on one NVIDIA card, end to end.

Run from the root of a checkout, on a machine with a CUDA card:

    python3 chip_smoke.py [--seed 0] [--out results.json]

Phases (any failure exits non-zero and prints no result line):

1. build: compile every kernel of the path (``ops/csrc/*.cu``, sm_90a)
   from the sources in this checkout;
2. kernels: each kernel against its plain PyTorch version on the card, on
   seeded random inputs at every shape the port gives it (for the LSTM:
   the serving step B=64 T=1, the learner's sequence B=32 T=16, the test
   shape, a batch with a partial row tile, the training path's B=128 at
   T=1 and T=17, the parity digest's B=1 T=1, the 5v5 league's B=1,280
   at T=1 and T=17, and its 64-game evaluation's B=320 T=1), with the f32
   tolerance stated below, its launch plan logged, and timed on the card (CUDA
   events around a CUDA graph of 100 calls, median of 11 replays; warm)
   beside its plain version, the one PyTorch call that computes the same
   function (``torch.lstm_cell`` at T=1; at T>1 cuDNN's ``torch.lstm`` on
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
   busy share and the kernels that took its time;
5. backward: ``LSTMSequenceFunction`` (the kernel's forward, the recompute
   backward) against autograd through the plain version at the learner's
   update shape (B=128, T=17, D=H=128) under one random cotangent, each
   gradient within BACKWARD_RTOL of its largest magnitude; the backward's
   time is logged;
6. train: ``Learner(cfg, actor="fused")`` on the default ``RunConfig``
   (LSTM(128), bf16 compute, f32 params from ``init_params`` with
   ``--seed``) at 128 games against the easy scripted bot, games of 20 s so
   that every game ends inside the phase and the update's sequence forward
   meets mid-chunk resets: 2 warm iterations, then 8 timed ones (16,384
   trained frames) run under ``torch.cuda.set_sync_debug_mode("error")``,
   so a read of the device from the host inside an iteration fails the
   run. Checked: finite loss and gradient norm and ``health_ok`` 1 in
   every iteration, every param tensor moved, every sampled action legal
   under its masks, episodes ended, and ``lstm_seq`` launched exactly
   iterations x (rollout_len + updates) times (its counts are reset just
   before the phase and read just after). Logged: trained frames/s, wall ms
   an iteration split into rollout and update by CUDA events, the LSTM
   backward's share of the update, and the card's busy share and top
   kernels in a torch.profiler window of 2 more iterations;
7. kernel against plain in the train step: on one chunk of the phase, from
   the phase's state, the loss and gradients with the kernel and with
   ``use_kernel=False``, at f32 compute (loss within TRAIN_LOSS_ATOL, each
   gradient within TRAIN_GRAD_RTOL of its largest magnitude) and at the
   phase's bf16 (the looser bf16 bounds below, logged beside their
   control); then, on the chunk with CAST and every ability slot made
   legal (the lane sim exposes one ability, so the phase's own masks leave
   the ability head a zero gradient), the same at f32 with the ability
   head's gradient nonzero, and one ``_train_step`` each way at f32 in
   which every param tensor moves;
8. socket: the phase-6 learner's state saved with the port's
   ``CheckpointManager`` and loaded as the serve CLI loads it
   (``load_inference_params``, then ``ServeEngine`` on the card behind a
   ``PolicyServer`` on 127.0.0.1): 64 ``ServeClient`` threads run 20
   lockstep steps each (1,280 requests, resets at episode starts) after one
   uncounted warm-up round; after round 7 one client closes and attaches
   again, and must land on its freed slot with a zeroed carry; then a raw
   peer sends ``poison_frame_limit`` frames with a bad payload CRC and must
   be quarantined. Checked: every step answered with a legal action at the
   checkpoint's version, no dispatch error, the quarantine and corrupt-frame
   counts, ``lstm_seq`` launched once a dispatch (its counts are reset just
   before the 20 rounds and read just after), and each game's stream
   replayed through the checkpoint's policy on the CPU, carries chained:
   the served log-probs within SOCKET_LOGP_ATOL, while two replays of a
   server that mishandles carries (each game handed another game's carry;
   carries never zeroed at a reset or reattach) must each read farther off
   than that, and the reattached game's first step replayed with its old
   carry kept farther off than the sound replay. Logged: the clients'
   round trip p50/p99 (host clock), requests/s, mean batch fill and
   dispatch mean, beside phase 3's in-process numbers;
9. cli: ``python -m dotaclient_tpu_torch.serve --checkpoint DIR`` as a
   child process: SERVE_LISTENING within 120 s (after its warm-up
   dispatch), 8 clients x 5 steps on the default ``ServeConfig`` deadline,
   as real games get it, then SIGINT; it must exit 0 with 40 requests at
   the checkpoint's version in its last line. Every wait is bounded and the
   child is killed on failure;
10. fleet parity: ``serve.loadgen.run_rehome_parity`` on the card with the
    checkpoint's params and config (LSTM(128), bf16): two backends and a
    hot spare behind a ``SessionRouter`` in this process, ``max_batch`` 1,
    probes every 0.1 s and a 0.4 s grace, one backend torn down after 5
    steps. Checked: the moved session's and the control's replies replayed
    bitwise through ``reference_step`` across the boundary (the shadow
    row copied between carry stores), the teeth check (a zeroed carry
    reads otherwise), the session on the spare, the router's re-home count,
    and ``lstm_seq`` launched once a dispatch and once a ``reference_step``,
    counted apart. Logged: the blackout;
11. fleet processes: three ``python -m dotaclient_tpu_torch.serve`` children
    on the checkpoint with ``--serve carry_shadow=true`` (A, B active; C a
    hot spare) under ``python -m dotaclient_tpu_torch.serve.router
    --metrics-jsonl``; 32 ``ServeClient(router=True)`` games step 8 rounds in
    lockstep, A gets SIGKILL, 8 more rounds on the default 10 s deadline,
    then SIGINT to the router, B and C. Checked: every step answered
    legally; each of A's games re-homed onto C; the router's last line 1
    death and A's games re-homed; a ``serve_peer_dead`` ALERT in its JSONL;
    B's and C's request counts equal the requests sent to them; their
    ``lstm_seq`` launches equal their dispatches; each game's log-probs
    replayed on the CPU with the shadow row carried across within
    SOCKET_LOGP_ATOL, and the same replay with a zeroed carry at the
    re-home above it. Logged: each game's blackout (SIGKILL to its first
    reply from C), round trip p50/p99 before and after, each child's start.
    Every child is killed in a ``finally``.
12. league: ``Learner(cfg, actor="fused")`` at the 5v5 league shape (256
    games, ``team_size`` 5, hero pool (1, 2, 3), ``opponent="league"``,
    PFSP with the default pool of 8 and ``selfplay_prob`` 0.5,
    ``anchor_prob`` 0.25 against the ``mixed`` anchor bots), with games of
    20 s, ``snapshot_every`` 2 and ``opponent_hold`` 2 so that the phase
    sees several snapshots and frozen draws: 2 warm iterations, then 8
    timed ones under ``torch.cuda.set_sync_debug_mode("error")`` (the PFSP
    flush at the end of ``train`` runs with the guard lifted). Checked:
    finite loss and ``health_ok`` 1, every param moved, every action of
    the learner lanes and of the opponent lanes legal under its masks,
    episodes ended, more than one snapshot, a frozen draw whose PFSP games
    equal the ``league_episodes`` its calls reported, every snapshot
    bitwise equal to its value when taken, and ``lstm_seq`` launched
    iterations x (2 x rollout_len + updates) times. Logged: trained
    frames/s, rollout and update ms, and the busy share and top kernels of
    2 more iterations under the profiler. Then, on its params:
    ``evaluate`` against ``scripted_hard`` and (league mode) against the
    step-0 snapshot, 64 games each (episodes >= games, win rate in [0, 1],
    ``lstm_seq`` launches = the policy steps it ran, wall time logged);
    ``python -m dotaclient_tpu_torch.league`` as a child on a checkpoint of
    the phase with ``--vs`` on a second; and ``python -m
    dotaclient_tpu_torch.train.demo`` as a child at a smoke size. Each
    child must exit 0 with its result line; every wait is bounded and every
    child is killed in a ``finally``.

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
import tempfile
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
# phase 8's replay of each game's stream over TCP, the same bf16 on both
# sides. The limit sits between the sound replays' readings (H100:
# 0.0018-0.0039) and the carry faults' (a reattached step served from the
# old carry: 0.0552); the same run's controls, replays of a server that
# mixes carries between games or never zeroes one, must read above it
SOCKET_LOGP_ATOL = 0.01
# the recompute backward is autograd through the plain version on the
# saved inputs, so it should equal the plain version's gradients
BACKWARD_RTOL = 1e-5
# kernel against plain inside one train step, from the phase's state on one
# of its chunks. At f32 compute: loss within TRAIN_LOSS_ATOL, each gradient
# within TRAIN_GRAD_RTOL of its largest magnitude. At the phase's bf16
# compute the kernel's f32 outputs (within ~2e-7 of the plain version's)
# round to a neighbouring bf16 value here and there (one ulp is 2^-8 of
# the value), and the gradients move by about an ulp of their largest
# entry. The control measures that: the plain version against itself with
# its f32 hs moved by uniform noise of CONTROL_NOISE (a tenth of the
# kernel's f32 tolerance) before the cast, on the same chunk. The bf16
# bounds sit between the kernel's reading and the control's (H100: 2.5e-7
# and 6.2e-3 against 2.0e-6 and 2.0e-2), and the kernel must also read
# below the control in the same run
TRAIN_LOSS_ATOL = 1e-4
TRAIN_GRAD_RTOL = 1e-3
TRAIN_BF16_LOSS_ATOL = 1e-6
TRAIN_BF16_GRAD_RTOL = 1e-2
CONTROL_NOISE = 1e-6

TRAIN_ENVS, TRAIN_MAX_DOTA_TIME = 128, 20.0
TRAIN_WARM, TRAIN_TIMED, TRAIN_PROFILED = 2, 8, 2

N_GAMES, N_STEPS = 64, 20
RELEASE_AFTER_ROUND, RELEASED_SLOTS = 7, (3, 40)
SWAP_AFTER_ROUND = 11


def log(msg: str) -> None:
    print(f"[chip_smoke] {msg}", flush=True)


def time_ms(fn, n: int = 200, warmup: int = 20, setup=None) -> float:
    """Median time of one call of ``fn`` in ms as a caller sees it: CUDA
    events around each single call, so the host's work to issue it counts
    wherever the card would otherwise wait for it. ``setup()``, run before
    each call's start event, makes its arguments."""
    import torch

    for _ in range(warmup):
        fn(*(setup() if setup else ()))
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(n)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(n)]
    for s, e in zip(starts, ends):
        args = setup() if setup else ()
        s.record()
        fn(*args)
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


# phase 12's league: its games, team size and game length, and its
# evaluations' games
LEAGUE_ENVS, LEAGUE_TEAM, LEAGUE_MAX_DOTA_TIME = 256, 5, 20.0
LEAGUE_EVAL_GAMES, LEAGUE_CLI_GAMES = 64, 16

# (B, T, D, H): the serving step, the learner's sequence, the small test
# shape, a batch that leaves one partial row tile, the fused training
# path's two (the rollout step over 128 lanes and the update's sequence
# forward, rollout_len 16 plus the bootstrap step), the re-home parity
# digest's step (max_batch 1), the 5v5 league's two (1,280 learner lanes,
# and as many opponent lanes, at T=1; the update at T=17), and the
# league evaluation's step (its games' learner lanes, and in league mode
# as many opponent lanes, at T=1)
LEAGUE_LANES, LEAGUE_EVAL_LANES = LEAGUE_ENVS * LEAGUE_TEAM, LEAGUE_EVAL_GAMES * LEAGUE_TEAM
LSTM_SHAPES = ((64, 1, 128, 128), (32, 16, 128, 128), (5, 3, 16, 32), (65, 2, 128, 128),
               (128, 1, 128, 128), (128, 17, 128, 128), (1, 1, 128, 128),
               (LEAGUE_LANES, 1, 128, 128), (LEAGUE_LANES, 17, 128, 128), (LEAGUE_EVAL_LANES, 1, 128, 128))


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
        if T == 1 and D == H == 128:
            library = lstm_cell_library(args)
            lib_h, lib_c = library()
            lib_err = max(float((lib_h - want[1][0]).abs().max()), float((lib_c - want[1][1]).abs().max()))
            log(f"torch.lstm_cell vs plain version: max abs err {lib_err:.3g}")
            shape["library_ms"] = device_ms(library)
            shape["call_ms"] = time_ms(lambda: lstm.lstm_sequence_kernel(*args))
        if T > 1 and D == H == 128 and B in (32, 128, LEAGUE_LANES):
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
    train_step, train_seq, digest_step = shapes[(128, 1)], shapes[(128, 17)], shapes[(1, 1)]
    league_step, league_seq = shapes[(LEAGUE_LANES, 1)], shapes[(LEAGUE_LANES, 17)]
    league_eval_step = shapes[(LEAGUE_EVAL_LANES, 1)]
    entry = {
        "name": "lstm_seq",
        "route": "cuda",
        "source": "dotaclient_tpu_torch/ops/csrc/lstm_seq.cu",
        "replaces": "dotaclient_tpu/ops/pallas/lstm.py:117",
        "launches": 0,
        "max_abs_err": max(s["max_abs_err"] for s in shapes.values()),
        "ms": serve["ms"],
        "plain_ms": serve["plain_ms"],
        "bound_ms": serve["bound_ms"],
        "bound_by": serve["bound_by"],
        "library_ms": serve["library_ms"],
        "plan": serve["plan"],
        "sequence_ms": sequence["ms"],
        "train_rollout_step_ms": train_step["ms"],
        "train_sequence_ms": train_seq["ms"],
        "digest_step_ms": digest_step["ms"],
        "league_rollout_step_ms": league_step["ms"],
        "league_sequence_ms": league_seq["ms"],
        "league_eval_step_ms": league_eval_step["ms"],
    }
    return entry, {"sequence": sequence, "train_rollout_step": train_step, "train_sequence": train_seq,
                   "digest_step": digest_step, "league_rollout_step": league_step, "league_sequence": league_seq,
                   "league_eval_step": league_eval_step, "shapes": list(shapes.values())}


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


MASK_KEYS = ("mask_action_type", "mask_target_unit", "mask_cast_target", "mask_ability")


def actions_legal(masks, acts):
    """Each row's sampled actions legal under its masks, with the
    all-illegal-row rule of the distribution (such a row is sampled as if
    all-legal): [B] bool, on the masks' device."""
    import torch

    def ok(mask, i):
        n = mask.shape[-1]
        picked = mask.gather(-1, i.clamp(0, n - 1).long()[:, None])[:, 0]
        return (i >= 0) & (i < n) & (picked | ~mask.any(dim=-1))

    a = acts["action_type"]
    good = ok(masks["mask_action_type"], a)
    for head in ("move_x", "move_y"):
        good &= (acts[head] >= 0) & (acts[head] < 9)
    tmask = torch.where((a == 3)[:, None], masks["mask_cast_target"], masks["mask_target_unit"])
    good &= ~((a == 2) | (a == 3)) | ok(tmask, acts["target_unit"])
    good &= (a != 3) | ok(masks["mask_ability"], acts["ability"])
    return good


def rows_legal(obs_rows, packed_rows):
    """``actions_legal`` over host rows, each one observation and its
    packed actions (one value a head, in ``distributions.HEADS`` order):
    [N] bool numpy."""
    import torch

    from dotaclient_tpu_torch.models import distributions as D

    masks = {k: torch.as_tensor(np.stack([np.asarray(o[k], bool) for o in obs_rows])) for k in MASK_KEYS}
    packed = torch.as_tensor(np.asarray(packed_rows, np.int64).reshape(len(packed_rows), len(D.HEADS)))
    return actions_legal(masks, {h: packed[:, i] for i, h in enumerate(D.HEADS)}).numpy()


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
    good = rows_legal([requests[r[0]][0] for r in replies], [r[3] for r in replies])
    illegal = [r[0] for r, ok in zip(replies, good) if not ok]
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


def profiled(fn):
    """Run ``fn`` under torch.profiler and reduce the window to the wall
    time, the device's busy time and share (device-side events only: a CPU
    op's self device time repeats the time of the kernels it launched) and
    the kernels that took the most device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0

    def dev_us(evt):
        return float(getattr(evt, "self_device_time_total", 0.0) or getattr(evt, "self_cuda_time_total", 0.0))

    # kernels and copies only: a user annotation (Optimizer.step#Adam.step)
    # is mirrored on the device timeline and spans the kernels inside it
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False)]
    device_us = sum(dev_us(e) for e in events)
    top = sorted(events, key=dev_us, reverse=True)[:12]
    return {
        "wall_ms": wall_s * 1e3,
        "device_events": sum(e.count for e in events),
        "device_busy_ms": device_us / 1e3 if device_us > 0 else None,
        "device_busy_share": (device_us / 1e6) / wall_s if device_us > 0 else None,
        "top_device_ops": [
            {"name": e.key, "device_us": dev_us(e), "count": e.count} for e in top if dev_us(e) > 0
        ],
    }


def log_profile(label, result):
    busy = result["device_busy_ms"]
    log(
        f"{label} in {result['wall_ms']:.1f} ms wall, {result['device_events']} kernels and copies, device busy "
        + ("not measured" if busy is None else f"{busy:.2f} ms ({result['device_busy_share']:.3f})")
    )
    for e in result["top_device_ops"]:
        log(f"  {e['device_us']:10.1f} us  x{e['count']:<5d} {e['name'][:90]}")


def profile_serve(device, seed, rounds: int = 5):
    """A few lockstep rounds on a fresh engine under torch.profiler (after
    a warm-up), reduced to the device's busy share of the wall clock and
    the kernels that took the most device time. Runs after the checked
    serve phase, whose launch counts are already read."""
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
    import torch

    torch.cuda.synchronize()
    before = reg.snapshot()["serve/dispatches_total"]
    result = profiled(lambda: run_games(engine, cfg, np.random.default_rng(seed + 300), params, N_GAMES, rounds,
                                        release_round=-1))
    engine.stop()
    dispatches = reg.snapshot()["serve/dispatches_total"] - before
    result = {"rounds": rounds, "dispatches": dispatches, **result}
    log_profile(f"profile: {dispatches:.0f} dispatches", result)
    return result


# -- phase 5: the LSTM kernel's recompute backward ----------------------------


def check_lstm_backward(device, seed, B=128, T=17, D=128, H=128):
    """``LSTMSequenceFunction`` with the kernel's forward against autograd
    through the plain version, on the card, under one random cotangent."""
    import torch

    from dotaclient_tpu_torch.ops import lstm

    args = lstm_inputs(B, T, D, H, seed + 500, device)
    g = torch.Generator().manual_seed(seed + 501)
    cot = [torch.randn(*s, generator=g).to(device) for s in ((B, T, H), (B, H), (B, H))]

    def kernel_forward():
        diff = [t.clone().requires_grad_(True) for t in args[:6]]
        outs = lstm.LSTMSequenceFunction.apply(lstm.lstm_sequence_kernel, *diff, args[6])
        return outs, diff

    def backward(outs, diff):
        return torch.autograd.grad(outs, diff, cot)

    got = backward(*kernel_forward())
    ref = [t.clone().requires_grad_(True) for t in args[:6]]
    rhs, (rhT, rcT) = lstm.lstm_sequence_reference(*ref, args[6])
    want = torch.autograd.grad((rhs, rhT, rcT), ref, cot)
    errs = {}
    for name, a, b in zip(("x", "h0", "c0", "wx", "wh", "b"), got, want):
        errs[name] = float((a - b).abs().max() / b.abs().max())
        if not errs[name] <= BACKWARD_RTOL:
            raise AssertionError(f"lstm backward: grad of {name} off by {errs[name]:.3g} of its max > {BACKWARD_RTOL}")
    def plain_forward_backward():
        diff = [t.clone().requires_grad_(True) for t in args[:6]]
        hs, (hT, cT) = lstm.lstm_sequence_reference(*diff, args[6])
        return torch.autograd.grad((hs, hT, cT), diff, cot)

    result = {
        "B": B, "T": T, "D": D, "H": H,
        "max_rel_err": errs,
        "backward_ms": time_ms(backward, n=30, warmup=3, setup=kernel_forward),
        "kernel_forward_ms": device_ms(lambda: lstm.lstm_sequence_kernel(*args)),
        "plain_forward_ms": device_ms(lambda: lstm.lstm_sequence_reference(*args)),
        # device time alone (a CUDA graph of 10 calls), the host's issue out
        "kernel_forward_backward_device_ms": device_ms(lambda: backward(*kernel_forward()), n=10),
        "plain_forward_backward_device_ms": device_ms(plain_forward_backward, n=10),
    }
    log(
        f"lstm backward B={B} T={T} D=H={H}: grads vs autograd through the plain version within "
        + ", ".join(f"{k} {v:.2g}" for k, v in errs.items())
        + f" of their max (rtol {BACKWARD_RTOL}); recompute backward {result['backward_ms']:.3f} ms "
        f"(CUDA events around the call, host issue included), kernel forward "
        f"{result['kernel_forward_ms'] * 1e3:.2f} us, plain forward {result['plain_forward_ms'] * 1e3:.2f} us; "
        f"device time of forward and backward in a CUDA graph: kernel forward with the recompute backward "
        f"{result['kernel_forward_backward_device_ms'] * 1e3:.1f} us, plain forward with autograd's backward "
        f"{result['plain_forward_backward_device_ms'] * 1e3:.1f} us"
    )
    return result


# -- phase 6: train ---------------------------------------------------------------


def train_config(seed):
    from dotaclient_tpu_torch.config import RunConfig

    cfg = RunConfig()
    return dataclasses.replace(
        cfg,
        env=dataclasses.replace(cfg.env, n_envs=TRAIN_ENVS, opponent="scripted_easy",
                                max_dota_time=TRAIN_MAX_DOTA_TIME),
        # no log boundary inside the phase: a log line reads the device
        log_every=10 ** 9,
        seed=seed,
    )


class Recorder:
    """Wraps a learner's fused step and its actor's rollout to record, with
    no read of the device: CUDA events at the start of each rollout, at its
    end and at the end of the update; each call's metrics; each chunk; and
    events around each LSTM recompute backward."""

    def __init__(self, learner):
        import torch

        from dotaclient_tpu_torch.ops import lstm

        self.marks, self.metrics, self.chunks, self.backward_marks = [], [], [], []
        actor = learner.device_actor
        rollout, fused = actor._rollout_impl, learner.fused_step
        backward = lstm.LSTMSequenceFunction.backward

        def event():
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            return e

        def timed_rollout(params, state, opp_params=None, **kw):
            start = event()
            out = rollout(params, state, opp_params, **kw)
            self.marks.append([start, event()])
            self.chunks.append(out[1])
            return out

        def timed_fused(state, actor_state, opp_params=None):
            out = fused(state, actor_state, opp_params)
            self.marks[-1].append(event())
            self.metrics.append(out[2])
            return out

        def timed_backward(ctx, *grads):
            start = event()
            out = backward(ctx, *grads)
            self.backward_marks.append((start, event()))
            return out

        actor._rollout_impl = timed_rollout
        learner.fused_step = timed_fused
        lstm.LSTMSequenceFunction.backward = staticmethod(timed_backward)
        self._restore = lambda: setattr(lstm.LSTMSequenceFunction, "backward", staticmethod(backward))

    def clear(self):
        """Forget the marks and metrics; the chunks are kept."""
        self.marks, self.metrics, self.backward_marks = [], [], []

    def close(self):
        self._restore()


def train_phase(device, seed):
    """The fused learner on the card: warm-up, the timed and checked
    iterations under the sync guard, then a profiled window."""
    import torch

    from dotaclient_tpu_torch.ops import lstm
    from dotaclient_tpu_torch.train.learner import Learner
    from dotaclient_tpu_torch.utils import telemetry

    cfg = train_config(seed)
    T = cfg.ppo.rollout_len
    updates = cfg.ppo.steps_per_batch * cfg.steps_per_dispatch
    learner = Learner(cfg, actor="fused", seed=seed, device=device, registry=telemetry.Registry())
    rec = Recorder(learner)
    before = {k: v.detach().clone() for k, v in learner.policy.state_dict().items()}
    try:
        torch.cuda.synchronize()
        lstm.lstm_sequence_kernel.launches = 0
        learner.train(TRAIN_WARM * updates)
        torch.cuda.synchronize()
        rec.clear()
        t0 = time.perf_counter()
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = learner.train(TRAIN_TIMED * updates)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        launches = lstm.lstm_sequence_kernel.launches
        iters = TRAIN_WARM + TRAIN_TIMED
        if launches != iters * (T + updates):
            raise AssertionError(f"lstm_seq launched {launches} times in {iters} iterations, "
                                 f"expected {iters * (T + updates)}")
        metrics = [{k: float(v) for k, v in m.items()} for m in rec.metrics]
        for i, m in enumerate(metrics):
            if not (np.isfinite(m["loss"]) and np.isfinite(m["grad_norm"]) and m["health_ok"] == 1.0):
                raise AssertionError(f"timed iteration {i}: loss {m['loss']}, grad_norm {m['grad_norm']}, "
                                     f"health_ok {m['health_ok']}")
        frames = TRAIN_TIMED * learner.device_actor.n_lanes * T
        if out["frames_trained"] != frames or len(metrics) != TRAIN_TIMED:
            raise AssertionError(f"{out['frames_trained']} frames in {len(metrics)} iterations, expected {frames}")
        rollout_ms = statistics.mean(a.elapsed_time(b) for a, b, _ in rec.marks)
        update_ms = statistics.mean(b.elapsed_time(c) for _, b, c in rec.marks)
        backward_ms = sum(a.elapsed_time(b) for a, b in rec.backward_marks) / TRAIN_TIMED
        if len(rec.backward_marks) != TRAIN_TIMED * updates:
            raise AssertionError(f"{len(rec.backward_marks)} LSTM backwards in {TRAIN_TIMED} iterations")
        chunks = list(rec.chunks)
        rec.clear()
        profile = profiled(lambda: learner.train(TRAIN_PROFILED * updates))
    finally:
        rec.close()
    moved, cast_legal, ability_choice = check_params_moved(before, learner.policy, chunks)
    illegal, n_actions = check_chunk_actions(chunks)
    if illegal:
        raise AssertionError(f"{illegal} of {n_actions} sampled actions illegal under their masks")
    stats = learner.device_actor.drain_stats()
    if not stats["episodes_done"] > 0:
        raise AssertionError("no episode ended in the train phase")
    result = {
        "n_envs": cfg.env.n_envs, "lanes": learner.device_actor.n_lanes, "rollout_len": T,
        "updates_per_iteration": updates, "warm_iterations": TRAIN_WARM, "timed_iterations": TRAIN_TIMED,
        "frames_trained": frames,
        "frames_per_s": frames / wall_s,
        "iteration_ms": wall_s * 1e3 / TRAIN_TIMED,
        "rollout_ms": rollout_ms,
        "update_ms": update_ms,
        "lstm_backward_ms_per_iteration": backward_ms,
        "lstm_backward_share_of_update": backward_ms / update_ms,
        "lstm_seq_launches": launches,
        "actions_checked": n_actions,
        "frames_that_could_cast": cast_legal,
        "frames_with_a_choice_of_ability": ability_choice,
        "params_moved": sum(moved.values()), "params": len(moved),
        "episodes_done": stats["episodes_done"],
        "win_rate": stats["win_rate"],
        "last_metrics": metrics[-1],
        "sync_debug_mode": "error",
        "profile": {"iterations": TRAIN_PROFILED, **profile},
    }
    log(
        f"train: {TRAIN_TIMED} timed fused iterations x {learner.device_actor.n_lanes} lanes x {T} steps = "
        f"{frames} trained frames in {wall_s * 1e3:.1f} ms: {result['frames_per_s']:.0f} frames/s, "
        f"{result['iteration_ms']:.2f} ms an iteration (rollout {rollout_ms:.2f} ms, update {update_ms:.2f} ms "
        f"between CUDA events; LSTM recompute backward {backward_ms:.2f} ms, "
        f"{result['lstm_backward_share_of_update']:.3f} of the update); no host sync inside the iterations; "
        f"loss {metrics[-1]['loss']:.4g}, grad_norm {metrics[-1]['grad_norm']:.4g}, health_ok 1 in all; "
        f"{n_actions} actions legal; {sum(moved.values())} of {len(moved)} param tensors moved "
        f"({cast_legal} frames could cast, {ability_choice} with a choice of ability); "
        f"{stats['episodes_done']:.0f} episodes; lstm_seq launches {launches}"
    )
    log_profile(f"train profile: {TRAIN_PROFILED} iterations", profile)
    return result, learner, chunks[-1]


def check_params_moved(before, policy, chunks):
    """Every param tensor of ``policy`` moved from ``before``, but the
    ability head where no frame of the chunks gave it a choice. Returns
    (moved by name, frames that could cast, those with a choice)."""
    import torch

    moved = {k: not torch.equal(v, before[k]) for k, v in policy.state_dict().items()}
    cast_legal, ability_choice = cast_frames(chunks)
    # the ability head's gradient is exactly 0 unless some frame could cast
    # with two or more abilities legal: with one, its distribution is a
    # point mass (log-prob 0 whatever the logits), and where CAST is
    # forbidden its terms are weighted by a probability of exactly 0. The
    # lane sim exposes one ability, so there it stays put; phase 7 holds its
    # gradient on the card on a chunk whose masks give it a choice
    still = [k for k, v in moved.items() if not v and not (k.startswith("head_ability.") and ability_choice == 0)]
    if still:
        raise AssertionError(f"params that did not move: {still} ({cast_legal} frames could cast, "
                             f"{ability_choice} of them with a choice of ability)")
    return moved, cast_legal, ability_choice


def cast_frames(chunks):
    """Frames of the chunks where CAST was legal, and those of them with two
    or more abilities legal."""
    from dotaclient_tpu_torch.envs.lane_sim import ACTION_CAST

    legal = choice = 0
    for c in chunks:
        can = c["obs"]["mask_action_type"][..., ACTION_CAST]
        legal += int(can.sum())
        choice += int((can & (c["obs"]["mask_ability"].sum(dim=-1) >= 2)).sum())
    return legal, choice


def check_chunk_actions(chunks):
    """Every sampled action of the chunks legal under its step's masks."""
    from dotaclient_tpu_torch.models import distributions as D

    illegal = n = 0
    for chunk in chunks:
        acts = {h: chunk["actions"][h].flatten(0, 1) for h in D.HEADS}
        L, T = chunk["actions"][D.HEADS[0]].shape[:2]
        good = actions_legal({k: chunk["obs"][k][:, :T].flatten(0, 1) for k in MASK_KEYS}, acts)
        illegal += int((~good).sum())
        n += good.numel()
    return illegal, n


# -- phase 7: the kernel against its plain version inside a train step --------


def loss_grads(learner, chunk, compute_dtype, use_kernel, hs_noise=None):
    """Loss and named gradients of one update's loss from a clone of the
    learner's state whose policy computes in ``compute_dtype``, and the
    kernel's launches in it. ``hs_noise`` (with the plain version) adds
    uniform noise of that size to the core's f32 outputs before their cast,
    and records how far the kernel's outputs on the same inputs lie from
    the plain version's."""
    import torch

    from dotaclient_tpu_torch.models import policy as P
    from dotaclient_tpu_torch.ops import lstm
    from dotaclient_tpu_torch.train import ppo

    state = learner.state.clone()
    state.policy.compute_dtype = compute_dtype
    gap, core_op = [], P.lstm_sequence
    if hs_noise is not None:
        gen = torch.Generator(device=chunk["rewards"].device).manual_seed(0)

        def noisy_plain(x, h0, c0, wx, wh, b, resets, use_kernel=True):
            hs, carry = core_op(x, h0, c0, wx, wh, b, resets, use_kernel=False)
            with torch.no_grad():
                gap.append(float((lstm.lstm_sequence_kernel(x, h0, c0, wx, wh, b, resets)[0] - hs).abs().max()))
            noise = (torch.rand(hs.shape, generator=gen, device=hs.device) * 2 - 1) * hs_noise
            return hs + noise, carry

        P.lstm_sequence = noisy_plain
    before = lstm.lstm_sequence_kernel.launches
    try:
        loss, _ = ppo.ppo_loss(state.policy, chunk, learner.config.ppo, step=state.step, use_kernel=use_kernel)
    finally:
        P.lstm_sequence = core_op
    launched = lstm.lstm_sequence_kernel.launches - before - len(gap)
    named = list(state.policy.named_parameters())
    grads = torch.autograd.grad(loss, [p for _, p in named])
    return {"loss": float(loss.detach()), "grads": {n: g for (n, _), g in zip(named, grads)},
            "launches": launched, "hs_gap": max(gap) if gap else None}


def compare_grads(a, b):
    """Loss difference and each gradient's max abs difference over its
    largest magnitude, ``a`` against the reference ``b``."""
    errs = {}
    for name, g in a["grads"].items():
        ref = b["grads"][name]
        scale = float(ref.abs().max())
        errs[name] = float((g - ref).abs().max()) / (scale if scale > 0 else 1.0)
    worst = max(errs, key=errs.get)
    return {"loss": a["loss"], "loss_ref": b["loss"], "loss_abs_err": abs(a["loss"] - b["loss"]),
            "worst_grad": worst, "worst_grad_rel_err": errs[worst],
            "lstm_grad_rel_err": {k: v for k, v in errs.items() if k.startswith("core.")}}


def kernel_vs_plain(learner, chunk, dtype, loss_tol, grad_tol, label):
    """The kernel against the plain version in one update's loss and
    gradients, checked within the stated tolerances; also the runs."""
    kern = loss_grads(learner, chunk, dtype, True)
    plain = loss_grads(learner, chunk, dtype, False)
    if (kern["launches"], plain["launches"]) != (1, 0):
        raise AssertionError(f"kernel launches in one loss: {kern['launches']} with the kernel, "
                             f"{plain['launches']} without")
    r = compare_grads(kern, plain)
    log(
        f"{label}, kernel vs plain: loss {r['loss']:.7g} vs {r['loss_ref']:.7g} (abs err {r['loss_abs_err']:.3g}, "
        f"atol {loss_tol}); worst grad {r['worst_grad']} within {r['worst_grad_rel_err']:.3g} of its max "
        f"(rtol {grad_tol}); LSTM grads " + ", ".join(f"{k} {v:.2g}" for k, v in r["lstm_grad_rel_err"].items())
    )
    if not r["loss_abs_err"] <= loss_tol:
        raise AssertionError(f"{label} loss: kernel {r['loss']} vs plain {r['loss_ref']}")
    if not r["worst_grad_rel_err"] <= grad_tol:
        raise AssertionError(f"{label} grad of {r['worst_grad']}: off by {r['worst_grad_rel_err']:.3g} "
                             f"of its max > {grad_tol}")
    return r, kern, plain


def with_ability_choice(chunk):
    """The chunk with CAST legal on every frame and every ability slot
    legal: masks under which the ability head has a distribution to learn."""
    from dotaclient_tpu_torch.envs.lane_sim import ACTION_CAST

    obs = dict(chunk["obs"])
    obs["mask_action_type"] = obs["mask_action_type"].clone()
    obs["mask_action_type"][..., ACTION_CAST] = True
    obs["mask_ability"] = obs["mask_ability"].clone().fill_(True)
    return {**chunk, "obs": obs}


def check_train_step_kernel(learner, chunk):
    """The kernel against its plain version inside the update, from the
    phase's state on one of its chunks: loss and gradients at f32 compute
    and at the phase's bf16, the bf16 reading beside its control (the plain
    version against itself with its outputs moved by CONTROL_NOISE), then
    on the chunk with a choice of ability (the ability head's gradient
    nonzero and matching) one whole ``_train_step`` each way at f32 (loss,
    pre-clip gradient norm, and every param moved)."""
    import torch

    from dotaclient_tpu_torch.train import ppo

    result = {}
    result["float32"], _, _ = kernel_vs_plain(learner, chunk, torch.float32, TRAIN_LOSS_ATOL, TRAIN_GRAD_RTOL,
                                              "train step at float32 compute")
    result["bfloat16"], _, plain = kernel_vs_plain(learner, chunk, torch.bfloat16, TRAIN_BF16_LOSS_ATOL,
                                                   TRAIN_BF16_GRAD_RTOL, "train step at bfloat16 compute")
    noisy = loss_grads(learner, chunk, torch.bfloat16, False, hs_noise=CONTROL_NOISE)
    control = compare_grads(noisy, plain)
    control.update(noise=CONTROL_NOISE, kernel_hs_gap=noisy["hs_gap"])
    result["bfloat16_control"] = control
    log(
        f"bf16 control, plain vs plain with its f32 hs moved by uniform noise of {CONTROL_NOISE:g} (the kernel's "
        f"hs lie within {noisy['hs_gap']:.3g} of the plain version's on these inputs): loss abs err "
        f"{control['loss_abs_err']:.3g}, worst grad {control['worst_grad']} within "
        f"{control['worst_grad_rel_err']:.3g} of its max; the kernel's: {result['bfloat16']['loss_abs_err']:.3g}, "
        f"{result['bfloat16']['worst_grad_rel_err']:.3g}"
    )
    for key in ("loss_abs_err", "worst_grad_rel_err"):
        if not result["bfloat16"][key] < control[key]:
            raise AssertionError(f"bf16 {key}: kernel {result['bfloat16'][key]:.3g} not below the control's "
                                 f"{control[key]:.3g}")

    wide = with_ability_choice(chunk)
    r, kern, plain = kernel_vs_plain(learner, wide, torch.float32, TRAIN_LOSS_ATOL, TRAIN_GRAD_RTOL,
                                     "train step at float32 compute with a choice of ability")
    for name in ("head_ability.weight", "head_ability.bias"):
        if not (kern["grads"][name].any() and plain["grads"][name].any()):
            raise AssertionError(f"{name}: zero gradient under masks that give the ability head a choice")
    result["float32_ability_choice"] = r
    steps = {}
    for use_kernel in (True, False):
        state = learner.state.clone()
        state.policy.compute_dtype = torch.float32
        before = {k: v.detach().clone() for k, v in state.policy.state_dict().items()}
        _, m = ppo._train_step(learner.config.ppo, state, wide, use_kernel=use_kernel)
        still = [k for k, v in state.policy.state_dict().items() if torch.equal(v, before[k])]
        if still:
            raise AssertionError(f"_train_step with use_kernel={use_kernel}: params that did not move: {still}")
        steps[use_kernel] = {k: float(m[k]) for k in ("loss", "grad_norm", "health_ok")}
    if not abs(steps[True]["loss"] - steps[False]["loss"]) <= TRAIN_LOSS_ATOL:
        raise AssertionError(f"_train_step loss: kernel {steps[True]} vs plain {steps[False]}")
    result["train_step_f32"] = {"kernel": steps[True], "plain": steps[False]}
    log(f"_train_step at float32 compute with a choice of ability, every param moved: "
        f"kernel {steps[True]}, plain {steps[False]}")
    return result


# -- phase 8: the socket lane, serving a checkpoint the learner wrote ----------


SOCKET_GAMES, SOCKET_STEPS = 64, 20
RECONNECT_GAME, RECONNECT_AFTER_ROUND = 5, 7
CLI_GAMES, CLI_STEPS = 8, 5
WAIT_S = 120.0


def wait_for(pred, what, timeout=WAIT_S):
    deadline = time.monotonic() + timeout
    while not pred():
        if time.monotonic() > deadline:
            raise AssertionError(f"timed out after {timeout:.0f} s waiting for {what}")
        time.sleep(0.01)


def lockstep_clients(host, port, cfg, rngs, n_steps, reconnect=None, router=False, before_round=None):
    """One ServeClient per game on its own thread, every round started
    together (a barrier). ``reconnect=(game, round, before_reconnect)``: that
    game closes after the round, calls ``before_reconnect()``, attaches
    again and sends its next step without a reset, so only the release's
    zeroing makes its carry fresh. ``router``: the clients attach through
    the session router at (host, port). ``before_round={round: fn}``: fn runs
    once all games are ready for that round, before any of them steps.
    Returns per game the (obs, reset, packed, logp, version, latency,
    backend address, re-home count, monotonic time of the reply) of each
    step and, per game, the slots it held."""
    import threading

    from dotaclient_tpu_torch.serve import ServeClient

    n = len(rngs)
    rounds = iter(range(n_steps))
    hooks = before_round or {}

    def at_barrier():
        fn = hooks.get(next(rounds))
        if fn is not None:
            fn()

    barrier = threading.Barrier(n, action=at_barrier)
    records = [[] for _ in range(n)]
    slots = [[] for _ in range(n)]
    errors = []

    def game(g):
        try:
            client = ServeClient(host, port, cfg, timeout_s=WAIT_S, router=router)
            slots[g].append(client.slot)
            ep_left, reattached = 0, False
            for r in range(n_steps):
                obs = synthetic_obs(cfg, rngs[g])
                reset = r == 0 or ep_left == 0
                if reset or reattached:
                    ep_left = int(rngs[g].integers(4, 12))
                ep_left -= 1
                reset, reattached = reset and not reattached, False
                barrier.wait(timeout=WAIT_S)
                client.step(obs, reset=reset)
                records[g].append((obs, reset, client.last_packed.copy(), client.last_logp, client.last_version,
                                   client.last_latency_s, tuple(client.backend_addr), client.rehomed_count,
                                   time.monotonic()))
                if reconnect is not None and g == reconnect[0] and r == reconnect[1]:
                    client.close()
                    reconnect[2]()
                    client = ServeClient(host, port, cfg, timeout_s=WAIT_S)
                    slots[g].append(client.slot)
                    reattached = True
            client.close()
        except BaseException as e:  # noqa: BLE001 - re-raised on the caller's thread
            errors.append(e)
            barrier.abort()

    threads = [threading.Thread(target=game, args=(g,), daemon=True) for g in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(WAIT_S * (n_steps + 2))
    if errors:
        raise errors[0]
    if any(t.is_alive() for t in threads):
        raise AssertionError("a client thread did not finish")
    return records, slots


CARRY_FAULTS = ("permuted", "kept")


def replay_logps_on_cpu(cfg, params, records, zeroed, fault=None):
    """Every game's own stream through the checkpoint's policy on the CPU,
    carries chained, resets applied (and the carry zeroed where ``zeroed``
    holds (game, round)): the log-prob of each served action. Returns the
    largest difference from the served log-probs and, for each entry of
    ``zeroed``, the replay's log-prob there with the carry kept instead.
    ``fault`` replays a server that mishandles carries, as a control:
    "permuted" hands each game the carry of the game before it, "kept"
    never zeroes a carry."""
    import torch

    from dotaclient_tpu_torch.models import distributions as D
    from dotaclient_tpu_torch.models.policy import mask_carry
    from dotaclient_tpu_torch.serve import make_inference_policy

    policy = make_inference_policy(cfg, device="cpu")
    policy.load_state_dict(params)
    n = len(records)
    carry = policy.initial_state(n)
    worst, kept = 0.0, {}
    with torch.no_grad():
        for r in range(len(records[0])):
            rows = [records[g][r] for g in range(n)]
            obs = {k: torch.from_numpy(np.stack([np.asarray(row[0][k]) for row in rows])) for k in rows[0][0]}
            actions = {h: torch.tensor([int(row[2][i]) for row in rows]) for i, h in enumerate(D.HEADS)}
            for g in (g for g in range(n) if (g, r) in zeroed):
                logits, _, _ = policy.step(obs, carry)
                kept[(g, r)] = float(D.log_prob(logits, obs, actions)[g])
            keep = torch.tensor([0.0 if (row[1] or (g, r) in zeroed) and fault != "kept" else 1.0
                                 for g, row in enumerate(rows)])
            carry = mask_carry(carry, keep)
            if fault == "permuted":
                carry = tuple(torch.roll(c, 1, 0) for c in carry)
            logits, _, carry = policy.step(obs, carry)
            ref = D.log_prob(logits, obs, actions).numpy()
            worst = max(worst, float(np.abs(ref - np.asarray([row[3] for row in rows], np.float32)).max()))
    return worst, kept


def socket_phase(device, seed, learner, ckpt_dir, inproc):
    """The serving path a game reaches from outside the process: the
    learner's state saved with the port's CheckpointManager, loaded as the
    CLI loads it, and served by a PolicyServer to 64 ServeClients over TCP.
    ``inproc`` is phase 3's result, logged beside this phase's."""
    import socket as pysocket

    import torch
    from google.protobuf import __version__ as pb_version
    from google.protobuf.internal import api_implementation

    from dotaclient_tpu_torch.ops import lstm
    from dotaclient_tpu_torch.serve import PolicyServer, ServeClient, ServeEngine, load_inference_params
    from dotaclient_tpu_torch.serve import make_inference_policy
    from dotaclient_tpu_torch.serve.server import KIND_SERVE_REQUEST
    from dotaclient_tpu_torch.transport.serialize import frame_crc32
    from dotaclient_tpu_torch.transport.socket_transport import _recv_frame, _send_frame
    from dotaclient_tpu_torch.utils import telemetry
    from dotaclient_tpu_torch.utils.checkpoint import CheckpointManager

    log(f"socket: protobuf {pb_version} ({api_implementation.Type()})")
    step = learner.state.step
    if not CheckpointManager(ckpt_dir, registry=telemetry.Registry()).save(learner.state, learner.config, force=True):
        raise AssertionError("checkpoint save failed")
    cfg, params, version = load_inference_params(ckpt_dir)
    if version != step or cfg.model != learner.config.model:
        raise AssertionError(f"checkpoint restored step {version} (saved {step}), model {cfg.model}")
    reg = telemetry.Registry()
    engine = ServeEngine(cfg, make_inference_policy(cfg, device=device), params, version=version,
                         registry=reg, device=device)
    warm_s = engine.warm_up()
    server = PolicyServer(engine, cfg, host="127.0.0.1", port=0, registry=reg)
    host, port = server.address[:2]
    try:
        # a warm-up round on the same server (its first dispatches), outside the counts
        lockstep_clients(host, port, cfg, [np.random.default_rng(seed + 900 + g) for g in range(SOCKET_GAMES)], 1)
        wait_for(lambda: server.n_connected == 0, "the warm-up clients to detach")
        before = reg.snapshot()
        torch.cuda.synchronize()
        lstm.lstm_sequence_kernel.launches = 0
        t0 = time.perf_counter()
        records, slots = lockstep_clients(
            host, port, cfg, [np.random.default_rng(seed + 1000 + g) for g in range(SOCKET_GAMES)], SOCKET_STEPS,
            reconnect=(RECONNECT_GAME, RECONNECT_AFTER_ROUND,
                       lambda: wait_for(lambda: server.n_connected == SOCKET_GAMES - 1, "the server to drop a client")),
        )
        wall = time.perf_counter() - t0
        launches = lstm.lstm_sequence_kernel.launches
        mid = reg.snapshot()

        # a peer that sends poison_frame_limit frames with a bad payload CRC
        limit = cfg.transport.poison_frame_limit
        raw = pysocket.create_connection((host, port), timeout=WAIT_S)
        try:
            if _recv_frame(raw) is None:
                raise AssertionError("no attach frame")
            payload = b"\x00" * 64
            for _ in range(limit):
                _send_frame(raw, KIND_SERVE_REQUEST, payload, crc=frame_crc32(payload) ^ 0xDEADBEEF)
            wait_for(lambda: reg.snapshot()["transport/peers_quarantined"] == mid["transport/peers_quarantined"] + 1,
                     "the poisoning peer's quarantine")
        finally:
            raw.close()
        after = reg.snapshot()
    finally:
        server.close()
        engine.stop()

    n = SOCKET_GAMES * SOCKET_STEPS
    flat = [rec for game in records for rec in game]
    if len(flat) != n:
        raise AssertionError(f"{len(flat)} steps returned, expected {n}")
    bad_version = [rec[4] for rec in flat if rec[4] != step]
    if bad_version:
        raise AssertionError(f"{len(bad_version)} replies carry version {bad_version[0]}, not the checkpoint's {step}")
    illegal = int((~rows_legal([rec[0] for rec in flat], [rec[2] for rec in flat])).sum())
    if illegal:
        raise AssertionError(f"{illegal} illegal actions")
    if not all(np.isfinite(rec[3]) for rec in flat):
        raise AssertionError("non-finite log-prob in a reply")
    if after["serve/dispatch_errors_total"] != 0:
        raise AssertionError(f"serve/dispatch_errors_total = {after['serve/dispatch_errors_total']}")
    quarantined = after["transport/peers_quarantined"] - mid["transport/peers_quarantined"]
    corrupt = after["transport/frames_corrupt_total"] - mid["transport/frames_corrupt_total"]
    if (quarantined, corrupt) != (1, limit):
        raise AssertionError(f"poisoning peer: {quarantined} quarantined, {corrupt} corrupt frames (limit {limit})")
    if slots[RECONNECT_GAME][0] != slots[RECONNECT_GAME][1]:
        raise AssertionError(f"the reconnecting game moved from slot {slots[RECONNECT_GAME][0]} to "
                             f"{slots[RECONNECT_GAME][1]}, not onto its freed slot")
    dispatches = int(mid["serve/dispatches_total"] - before["serve/dispatches_total"])
    if launches != dispatches:
        raise AssertionError(f"{launches} lstm_seq launches for {dispatches} dispatches")
    requests = int(mid["serve/requests_total"] - before["serve/requests_total"])
    if requests != n:
        raise AssertionError(f"the server counted {requests} requests, expected {n}")
    fresh = (RECONNECT_GAME, RECONNECT_AFTER_ROUND + 1)
    logp_err, kept = replay_logps_on_cpu(cfg, params, records, {fresh})
    if not logp_err <= SOCKET_LOGP_ATOL:
        raise AssertionError(f"served log-probs vs the checkpoint's policy on the CPU: {logp_err} > {SOCKET_LOGP_ATOL}")
    # the controls: the limit must tell a server that mishandles carries
    # from a sound one, in this run
    controls = {fault: replay_logps_on_cpu(cfg, params, records, {fresh}, fault=fault)[0] for fault in CARRY_FAULTS}
    blind = {fault: err for fault, err in controls.items() if not err > SOCKET_LOGP_ATOL}
    if blind:
        raise AssertionError(f"carry-fault controls {blind} read within the limit {SOCKET_LOGP_ATOL}")
    # the reattached game's first step: served from a zeroed carry, so the
    # replay that keeps the old carry must read farther off than the fresh one
    served_logp = records[fresh[0]][fresh[1]][3]
    kept_gap = abs(kept[fresh] - served_logp)
    if not kept_gap > logp_err:
        raise AssertionError(f"the reattached game's first step: served {served_logp}, a kept carry gives "
                             f"{kept[fresh]} (gap {kept_gap:.3g}), no farther than the replay's error {logp_err:.3g}")
    lat_ms = np.asarray([rec[5] * 1e3 for rec in flat])
    span, req_span = "span/serve/dispatch", "span/serve/request"

    def span_mean_ms(name):
        return 1e3 * (mid[f"{name}/total_s"] - before[f"{name}/total_s"]) / max(
            1.0, mid[f"{name}/count"] - before[f"{name}/count"])

    result = {
        "checkpoint_step": step,
        "requests": n,
        "dispatches": dispatches,
        "mean_batch_fill": n / (dispatches * cfg.serve.max_batch),
        "requests_per_s": n / wall,
        "round_trip_p50_ms": float(np.percentile(lat_ms, 50)),
        "round_trip_p99_ms": float(np.percentile(lat_ms, 99)),
        "round_trip_mean_ms": float(lat_ms.mean()),
        # arrival at ServeEngine.submit to the reply callback, on the server
        "server_request_mean_ms": span_mean_ms(req_span),
        "dispatch_mean_ms": span_mean_ms(span),
        "dispatch_errors": int(after["serve/dispatch_errors_total"]),
        "reconnect": {"game": RECONNECT_GAME, "slots": slots[RECONNECT_GAME]},
        "quarantined": int(quarantined),
        "corrupt_frames": int(corrupt),
        "logp_err_vs_cpu_replay": logp_err,
        "logp_atol": SOCKET_LOGP_ATOL,
        "carry_fault_controls": controls,
        "reattached_step_gap_with_kept_carry": kept_gap,
        "warm_up_s": warm_s,
        "lstm_seq_launches": launches,
        "protobuf": f"{pb_version} ({api_implementation.Type()})",
    }
    log(
        f"socket: checkpoint step {step} served to {SOCKET_GAMES} clients over TCP, {n} requests, {dispatches} "
        f"dispatches, mean batch fill {result['mean_batch_fill']:.3f}, {result['requests_per_s']:.0f} req/s, "
        f"client round trip p50 {result['round_trip_p50_ms']:.3f} ms p99 {result['round_trip_p99_ms']:.3f} ms "
        f"mean {result['round_trip_mean_ms']:.3f} ms (host clock, 64 client threads and the server's threads on "
        f"one interpreter), of it on the server from submit to reply {result['server_request_mean_ms']:.3f} ms "
        f"mean, dispatch mean {result['dispatch_mean_ms']:.3f} ms; game {RECONNECT_GAME} reconnected onto slot "
        f"{slots[RECONNECT_GAME][1]} and its next step was served from a zeroed carry (a kept carry's replay is "
        f"{kept_gap:.3g} off); poisoning peer quarantined after {int(corrupt)} corrupt frames; "
        f"log-probs vs the checkpoint's policy on the CPU within {logp_err:.3g} (atol {SOCKET_LOGP_ATOL}; "
        f"controls: another game's carry {controls['permuted']:.3g}, carries never zeroed {controls['kept']:.3g}); "
        f"warm-up dispatch {warm_s:.3f} s; lstm_seq launches {launches}"
    )
    log(
        f"socket vs in process (phase 3, the same stream through ServeEngine.submit): "
        f"{result['requests_per_s']:.0f} vs {inproc['requests_per_s']:.0f} req/s, p50 "
        f"{result['round_trip_p50_ms']:.3f} vs {inproc['request_p50_ms']:.3f} ms, p99 "
        f"{result['round_trip_p99_ms']:.3f} vs {inproc['request_p99_ms']:.3f} ms, dispatch mean "
        f"{result['dispatch_mean_ms']:.3f} vs {inproc['dispatch_mean_ms']:.3f} ms, mean batch fill "
        f"{result['mean_batch_fill']:.3f} vs {inproc['mean_batch_fill']:.3f}"
    )
    return result


# -- phase 9: the serve CLI in a child process ------------------------------------


class Child:
    """A child process of the port with its merged output read line by line
    on a thread. ``kill`` (SIGKILL) leaves nothing running."""

    def __init__(self, args):
        import os
        import pathlib
        import queue
        import threading

        root = str(pathlib.Path(__file__).resolve().parent)
        env = {**os.environ, "PYTHONPATH": root + os.pathsep + os.environ.get("PYTHONPATH", "")}
        self.t0 = time.perf_counter()
        self.proc = subprocess.Popen([sys.executable, "-m", *args], cwd=root, env=env, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True)
        self._lines = queue.Queue()
        self.seen = []
        self._reader = threading.Thread(
            target=lambda: [self._lines.put(line.rstrip("\n")) for line in self.proc.stdout], daemon=True)
        self._reader.start()

    def wait_line(self, prefix, what):
        """The JSON after ``prefix`` on the first line that starts with it,
        and the seconds from the spawn to that line."""
        import queue

        deadline = time.monotonic() + WAIT_S
        while True:
            try:
                line = self._lines.get(timeout=max(0.0, deadline - time.monotonic()))
            except queue.Empty:
                raise AssertionError(f"{what} printed no {prefix.strip()} within {WAIT_S:.0f} s: "
                                     f"{self.seen[-5:]}") from None
            self.seen.append(line)
            if line.startswith(prefix):
                return json.loads(line[len(prefix):]), time.perf_counter() - self.t0

    def drain(self):
        while not self._lines.empty():
            self.seen.append(self._lines.get())
        return self.seen

    def stop(self, sig):
        """Send ``sig``, wait for the exit; returns (exit code, every line)."""
        self.proc.send_signal(sig)
        rc = self.proc.wait(timeout=WAIT_S)
        self._reader.join(30)
        return rc, self.drain()

    def kill(self):
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait(timeout=30)


def cli_phase(ckpt_dir, step, seed):
    """``python -m dotaclient_tpu_torch.serve --checkpoint DIR`` as a child
    process: wait for SERVE_LISTENING, serve 8 clients x 5 steps, SIGINT,
    and read its final line."""
    import signal

    from dotaclient_tpu_torch.utils import telemetry
    from dotaclient_tpu_torch.utils.checkpoint import CheckpointManager

    child = Child(["dotaclient_tpu_torch.serve", "--checkpoint", ckpt_dir, "--serve-listen", "127.0.0.1:0"])
    try:
        addr, start_s = child.wait_line("SERVE_LISTENING ", "the serve CLI")
        # the clients keep the stored ServeConfig's deadline budget
        cfg = CheckpointManager(ckpt_dir, registry=telemetry.Registry()).restore_config()
        records, _ = lockstep_clients(addr["host"], addr["port"], cfg,
                                      [np.random.default_rng(seed + 2000 + g) for g in range(CLI_GAMES)], CLI_STEPS)
        rc, seen = child.stop(signal.SIGINT)
    except BaseException:
        log("the serve CLI's output so far:\n" + "\n".join(child.drain()[-20:]))
        raise
    finally:
        child.kill()
    if rc != 0:
        raise AssertionError(f"the serve CLI exited {rc}: {seen[-10:]}")
    final = json.loads(seen[-1])
    n = CLI_GAMES * CLI_STEPS
    if final["serve_requests_total"] != n or final["serve_weights_version"] != step:
        raise AssertionError(f"the serve CLI's last line {final}: expected {n} requests at version {step}")
    flat = [rec for game in records for rec in game]
    if not (rows_legal([rec[0] for rec in flat], [rec[2] for rec in flat]).all()
            and all(rec[4] == step for rec in flat)):
        raise AssertionError("an illegal action or a wrong version from the serve CLI")
    listening = next(line for line in seen if line.startswith("serve: listening"))
    ready = [line for line in seen if line.startswith(("serve: kernels ready", "serve: warm-up"))]
    log(f"cli: {'; '.join(ready + [listening])}; SERVE_LISTENING after {start_s:.1f} s; {n} requests served within "
        f"the clients' {cfg.serve.request_deadline_s:.0f} s deadline; exit 0 on SIGINT; last line {json.dumps(final)}")
    return {"start_s": start_s, "requests": n, "final": final}


# -- phase 10: the re-home parity digest at full width, in one process ------------


def fleet_parity_phase(device, seed, ckpt_dir):
    """``run_rehome_parity`` on the card with the checkpoint's params and
    config (the default ModelConfig): two backends and a hot spare behind a
    SessionRouter in this process, one backend torn down after 5 steps, the
    moved session's replies replayed bitwise through ``reference_step``.
    The engines' dispatches and the replay's ``reference_step`` calls are
    counted apart, each against its ``lstm_seq`` launches."""
    import torch

    from dotaclient_tpu_torch.config import ModelConfig
    from dotaclient_tpu_torch.ops import lstm
    from dotaclient_tpu_torch.serve import ServeEngine, load_inference_params
    from dotaclient_tpu_torch.serve.loadgen import run_rehome_parity

    cfg, params, _ = load_inference_params(ckpt_dir)
    if cfg.model != ModelConfig():
        raise AssertionError(f"the checkpoint's model {cfg.model} is not the default ModelConfig()")
    counts = {"dispatches": 0, "replay_steps": 0, "replay_launches": 0}
    dispatch_window, reference_step = ServeEngine._dispatch_window, ServeEngine.reference_step

    def counted_window(self, rows):
        dispatch_window(self, rows)
        counts["dispatches"] += 1

    def counted_reference(self, *args, **kw):
        before = lstm.lstm_sequence_kernel.launches
        out = reference_step(self, *args, **kw)
        counts["replay_steps"] += 1
        counts["replay_launches"] += lstm.lstm_sequence_kernel.launches - before
        return out

    ServeEngine._dispatch_window, ServeEngine.reference_step = counted_window, counted_reference
    try:
        torch.cuda.synchronize()
        lstm.lstm_sequence_kernel.launches = 0
        t0 = time.perf_counter()
        digest = run_rehome_parity(seed=seed, device=device, config=cfg, params=params)
        wall_s = time.perf_counter() - t0
        launches = lstm.lstm_sequence_kernel.launches
    finally:
        ServeEngine._dispatch_window, ServeEngine.reference_step = dispatch_window, reference_step
    fleet_launches = launches - counts["replay_launches"]
    checks = {
        "parity bitwise": digest["parity"] == "bitwise",
        "teeth": digest["teeth"] is True,
        "re-homed to the spare": digest["rehomed_to_spare"] is True,
        "router counted a re-home": digest["router_sessions_rehomed"] >= 1,
        "launches = dispatches": fleet_launches == counts["dispatches"] > 0,
        "replay launches = reference_step calls": counts["replay_launches"] == counts["replay_steps"] > 0,
    }
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"fleet parity: {failed} failed: {digest}, {counts}, {fleet_launches} fleet launches")
    result = {**digest, **counts, "lstm_seq_launches": fleet_launches, "wall_s": wall_s,
              "model": dataclasses.asdict(cfg.model)}
    log(
        f"fleet parity: {digest['steps']} steps of 2 games over 3 engines at LSTM({cfg.model.hidden_dim}) "
        f"{cfg.model.dtype}, max_batch 1; one backend torn down after 5 steps, its session re-homed to the spare "
        f"(router: {digest['router_sessions_rehomed']} re-homed, {digest['router_backend_deaths']} death); "
        f"replay {digest['parity']} with teeth; blackout {digest['blackout_s']:.3f} s; lstm_seq launches "
        f"{fleet_launches} = {counts['dispatches']} dispatches, and {counts['replay_launches']} in "
        f"{counts['replay_steps']} reference_step calls; {wall_s:.1f} s"
    )
    return result


# -- phase 11: the fleet as an operator runs it, in processes ---------------------


FLEET_GAMES, FLEET_STEPS, FLEET_KILL_ROUND = 32, 16, 8


def fleet_cli_phase(ckpt_dir, step, seed):
    """Three serve CLIs on the checkpoint with ``--serve carry_shadow=true``
    and the router CLI over them (A and B active, C a hot spare); 32 games
    attach through the router and step in lockstep; after 8 rounds backend
    A's process gets SIGKILL; 8 more rounds on the default 10 s deadline;
    then SIGINT to the router and the surviving CLIs."""
    import pathlib
    import signal
    import socket

    from dotaclient_tpu_torch.serve import load_inference_params, route_call
    from dotaclient_tpu_torch.utils import telemetry
    from dotaclient_tpu_torch.utils.checkpoint import CheckpointManager

    jsonl = f"{ckpt_dir}/router.jsonl"
    serves = [Child(["dotaclient_tpu_torch.serve", "--checkpoint", ckpt_dir, "--serve-listen", "127.0.0.1:0",
                     "--serve", "carry_shadow=true"]) for _ in range(3)]
    children = list(serves)
    kill = {}
    try:
        started = [c.wait_line("SERVE_LISTENING ", f"serve CLI {n}") for n, c in zip("ABC", serves)]
        addrs = [(a["host"], int(a["port"])) for a, _ in started]
        router = Child(["dotaclient_tpu_torch.serve.router", "--backends", ",".join(f"{h}:{p}" for h, p in addrs[:2]),
                        "--spares", "%s:%d" % addrs[2], "--metrics-jsonl", jsonl])
        children.append(router)
        raddr, router_s = router.wait_line("ROUTER_LISTENING ", "the router CLI")
        rhost, rport = raddr["host"], int(raddr["port"])

        def status():
            sock = socket.create_connection((rhost, rport), timeout=WAIT_S)
            try:
                return route_call(sock, {"op": "status"}, timeout=WAIT_S)
            finally:
                sock.close()

        wait_for(lambda: all(b["live"] for b in status()["backends"]), "the router's probes to find 3 live backends")
        stored = CheckpointManager(ckpt_dir, registry=telemetry.Registry()).restore_config()
        cfg = dataclasses.replace(stored, serve=dataclasses.replace(stored.serve, carry_shadow=True))

        def sigkill_a():
            kill["t"] = time.monotonic()
            serves[0].proc.kill()

        records, _ = lockstep_clients(rhost, rport, cfg, [np.random.default_rng(seed + 3000 + g)
                                                          for g in range(FLEET_GAMES)],
                                      FLEET_STEPS, router=True, before_round={FLEET_KILL_ROUND: sigkill_a})
        wait_for(lambda: '"serve_peer_dead"' in pathlib.Path(jsonl).read_text(), "the serve_peer_dead ALERT")
        ends = {name: c.stop(signal.SIGINT) for name, c in (("router", router), ("B", serves[1]), ("C", serves[2]))}
        serves[0].proc.wait(timeout=30)
    except BaseException:
        for name, c in zip(("A", "B", "C", "router"), children):
            log(f"fleet: {name}'s output so far:\n" + "\n".join(c.drain()[-15:]))
        raise
    finally:
        for c in children:
            c.kill()
    bad_rc = {name: rc for name, (rc, _) in ends.items() if rc != 0}
    if bad_rc:
        raise AssertionError(f"fleet: exit codes {bad_rc}: " + "; ".join(f"{n}: {ends[n][1][-5:]}" for n in bad_rc))
    finals = {name: json.loads(lines[-1]) for name, (_, lines) in ends.items()}
    A, B, C = addrs
    on_a = [g for g in range(FLEET_GAMES) if records[g][FLEET_KILL_ROUND - 1][6] == A]
    flat = [rec for game in records for rec in game]
    failed = []
    if (len(flat) != FLEET_GAMES * FLEET_STEPS
            or not rows_legal([rec[0] for rec in flat], [rec[2] for rec in flat]).all()
            or not all(rec[4] == step for rec in flat)):
        failed.append("every request answered with a legal action at the checkpoint's version")
    if not on_a or not all(records[g][-1][7] >= 1 and records[g][-1][6] == C for g in on_a):
        failed.append(f"each of A's {len(on_a)} games re-homed onto C")
    if any(rec[7] != 0 for g in range(FLEET_GAMES) if g not in on_a for rec in records[g]):
        failed.append("the games on B stayed")
    if (finals["router"]["router_backend_deaths"], finals["router"]["router_sessions_rehomed"]) != (1, len(on_a)):
        failed.append(f"the router's last line {finals['router']}: 1 death and {len(on_a)} re-homed")
    events = [json.loads(line) for line in pathlib.Path(jsonl).read_text().splitlines() if '"event"' in line]
    if not any(e["rule"] == "serve_peer_dead" and e["state"] == "fired" for e in events):
        failed.append("a serve_peer_dead ALERT in the router's JSONL")
    sent = {name: sum(rec[6] == addr for rec in flat) for name, addr in (("B", B), ("C", C))}
    served = {name: int(finals[name]["serve_requests_total"]) for name in ("B", "C")}
    if sent != served:
        failed.append(f"requests sent after attaching {sent} = requests B and C counted {served}")
    # each CLI's count includes its warm-up dispatch
    launches = {name: finals[name]["lstm_seq_launches"] - 1 for name in ("B", "C")}
    dispatches = {name: int(finals[name]["serve_dispatches_total"]) for name in ("B", "C")}
    if launches != dispatches or not all(launches.values()):
        failed.append(f"lstm_seq launches {launches} = dispatches {dispatches}")
    _, params, _ = load_inference_params(ckpt_dir)
    logp_err, _ = replay_logps_on_cpu(cfg, params, records, set())
    zeroed_err, _ = replay_logps_on_cpu(cfg, params, records, {(g, FLEET_KILL_ROUND) for g in on_a})
    if not logp_err <= SOCKET_LOGP_ATOL:
        failed.append(f"replay with the shadow row carried across {logp_err:.3g} <= {SOCKET_LOGP_ATOL}")
    if not zeroed_err > SOCKET_LOGP_ATOL:
        failed.append(f"replay with a zeroed carry at the re-home {zeroed_err:.3g} > {SOCKET_LOGP_ATOL}")
    if failed:
        raise AssertionError(f"fleet: failed: {failed}")
    blackouts = [next(rec[8] for rec in records[g][FLEET_KILL_ROUND:] if rec[6] == C) - kill["t"] for g in on_a]
    lat = {when: np.asarray([rec[5] * 1e3 for game in records for rec in rows(game)])
           for when, rows in (("before", lambda game: game[:FLEET_KILL_ROUND]),
                              ("after", lambda game: game[FLEET_KILL_ROUND + 1:]))}
    result = {
        "games": FLEET_GAMES, "steps": FLEET_STEPS, "kill_after_round": FLEET_KILL_ROUND,
        "games_on_a": len(on_a), "requests_sent": sent, "finals": finals,
        "cli_start_s": {n: s for n, (_, s) in zip("ABC", started)}, "router_start_s": router_s,
        "blackout_s": {"min": min(blackouts), "max": max(blackouts), "all": blackouts},
        "round_trip_ms": {when: {"p50": float(np.percentile(v, 50)), "p99": float(np.percentile(v, 99))}
                          for when, v in lat.items()},
        "logp_err_vs_cpu_replay": logp_err, "zeroed_carry_control": zeroed_err,
        "alerts": [(e["rule"], e["state"]) for e in events],
        "lstm_seq_launches": sum(launches.values()), "launches_by_backend": launches,
    }
    log(
        f"fleet: 3 serve CLIs up after {', '.join(f'{s:.1f}' for _, s in started)} s, the router CLI after "
        f"{router_s:.1f} s; {FLEET_GAMES} games x {FLEET_STEPS} lockstep steps through the router, {len(on_a)} on A; "
        f"A SIGKILLed after round {FLEET_KILL_ROUND}; each of A's games answered again by C after "
        f"{min(blackouts):.3f}-{max(blackouts):.3f} s (deadline {cfg.serve.request_deadline_s:.0f} s); round trip "
        f"p50/p99 {result['round_trip_ms']['before']['p50']:.2f}/{result['round_trip_ms']['before']['p99']:.2f} ms "
        f"before the kill, {result['round_trip_ms']['after']['p50']:.2f}/{result['round_trip_ms']['after']['p99']:.2f} "
        f"ms after; router: {finals['router']}; alerts {result['alerts']}; requests B {served['B']}, C {served['C']} "
        f"= sent; replay within {logp_err:.3g} (atol {SOCKET_LOGP_ATOL}), a zeroed carry at the re-home "
        f"{zeroed_err:.3g}; lstm_seq launches B {launches['B']}, C {launches['C']} = their dispatches"
    )
    return result


# -- phase 12: league self-play at the 5v5 league shape ------------------------------


LEAGUE_WARM, LEAGUE_TIMED, LEAGUE_PROFILED = 2, 8, 2
DEMO_ARGS = ("--steps", "4", "--n-envs", "64", "--team-size", "5", "--opponent", "league",
             "--max-dota-time", "20", "--eval-games", "16")
CHILD_S = 600.0


def league_config(seed):
    """BASELINE config 5's league shape at the default model: 256 games of
    5v5, hero pool (1, 2, 3), PFSP at the default pool and self-play share,
    a quarter of the games anchored to the mixed bots; cut to 20 s games,
    a snapshot every 2 steps and draws held for 2."""
    from dotaclient_tpu_torch.config import RunConfig

    cfg = RunConfig()
    return dataclasses.replace(
        cfg,
        env=dataclasses.replace(cfg.env, n_envs=LEAGUE_ENVS, team_size=LEAGUE_TEAM, hero_pool=(1, 2, 3),
                                opponent="league", max_dota_time=LEAGUE_MAX_DOTA_TIME),
        league=dataclasses.replace(cfg.league, enabled=True, snapshot_every=2, opponent_hold=2,
                                   anchor_prob=0.25, anchor_opponent="mixed"),
        # no log boundary inside the phase: a log line reads the device
        log_every=10 ** 9,
        seed=seed,
    )


class LeagueRecorder(Recorder):
    """The ``Recorder``, and, with no read of the device: each fused call's
    opponent uid and stats, a copy of every snapshot as it is taken, and
    every ``distributions.sample`` call's masks and actions (in a league
    rollout the calls alternate learner lanes, opponent lanes). The PFSP
    flush, a read of the device at the end of ``train``, runs with the sync
    guard lifted."""

    def __init__(self, learner):
        import torch

        from dotaclient_tpu_torch.models import distributions as D

        super().__init__(learner)
        pool = learner.league
        self.reports, self.samples = [], []
        self.witness = {s.uid: {k: v.clone() for k, v in s.params.items()} for s in pool.snapshots}
        report, snapshot, flush, sample = (learner._report_league, pool.maybe_snapshot,
                                           learner._flush_league_reports, D.sample)

        def recording_report(uid, stats):
            self.reports.append((uid, stats))
            report(uid, stats)

        def witnessed_snapshot(params, version, step):
            took = snapshot(params, version, step)
            if took:
                snap = pool.snapshots[-1]
                self.witness[snap.uid] = {k: v.clone() for k, v in snap.params.items()}
            return took

        def unguarded_flush():
            mode = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode(0)
            try:
                flush()
            finally:
                torch.cuda.set_sync_debug_mode(mode)

        def recording_sample(logits, obs, **kw):
            acts, logp = sample(logits, obs, **kw)
            self.samples.append(({k: v for k, v in obs.items() if k.startswith("mask_")}, acts))
            return acts, logp

        learner._report_league = recording_report
        pool.maybe_snapshot = witnessed_snapshot
        learner._flush_league_reports = unguarded_flush
        D.sample = recording_sample
        restore = self._restore

        def restore_all():
            restore()
            D.sample = sample

        self._restore = restore_all


def counted_eval(learner, mode, opponent_params, seed, device):
    """``evaluate`` of the learner's params, its wall time and its
    ``lstm_seq`` launches beside the policy steps its collects ran."""
    import torch

    from dotaclient_tpu_torch.actor.device_rollout import DeviceActor
    from dotaclient_tpu_torch.league import evaluate
    from dotaclient_tpu_torch.ops import lstm

    collect, sides = DeviceActor.collect, []

    def counting(self, params, opp_params=None):
        sides.append(1 + (self._opp_feat is not None))
        return collect(self, params, opp_params)

    torch.cuda.synchronize()
    before = lstm.lstm_sequence_kernel.launches
    t0 = time.perf_counter()
    DeviceActor.collect = counting
    try:
        result = evaluate(learner.config, learner.policy, learner.policy.state_dict(), mode,
                          opponent_params=opponent_params, n_games=LEAGUE_EVAL_GAMES, seed=seed, device=device)
        torch.cuda.synchronize()
    finally:
        DeviceActor.collect = collect
    wall_s = time.perf_counter() - t0
    launches = lstm.lstm_sequence_kernel.launches - before
    T = learner.config.ppo.rollout_len
    steps = len(sides) * T
    if launches != sum(sides) * T:
        raise AssertionError(f"evaluate vs {mode}: lstm_seq launched {launches} times in {steps} rollout steps "
                             f"of {sides[0]} policy step(s) each")
    if not (result["episodes"] >= LEAGUE_EVAL_GAMES and 0.0 <= result["win_rate"] <= 1.0):
        raise AssertionError(f"evaluate vs {mode}: {result} for {LEAGUE_EVAL_GAMES} games")
    log(f"evaluate vs {mode}: {LEAGUE_EVAL_GAMES} games, {result['episodes']:.0f} episodes, win rate "
        f"{result['win_rate']:.4f}, episode reward {result['episode_reward_mean']:.4g}; {len(sides)} collects, "
        f"{steps} rollout steps, lstm_seq launches {launches}; {wall_s:.2f} s wall")
    return {**result, "collects": len(sides), "rollout_steps": steps, "lstm_seq_launches": launches,
            "wall_s": wall_s}


def run_child(args, what):
    """A child of the port run to its exit within CHILD_S: (its lines, its
    wall seconds). It must exit 0; it is killed in a ``finally``."""
    child = Child(list(args))
    try:
        rc = child.proc.wait(timeout=CHILD_S)
        child._reader.join(30)
        lines = child.drain()
    except BaseException:
        log(f"{what}'s output so far:\n" + "\n".join(child.drain()[-20:]))
        raise
    finally:
        child.kill()
    wall_s = time.perf_counter() - child.t0
    if rc != 0:
        raise AssertionError(f"{what} exited {rc}: {lines[-10:]}")
    return lines, wall_s


def league_children(learner, ckpt_dir):
    """The league CLI on a checkpoint of the phase against a second one
    (the step-0 snapshot's params), and the demo at a smoke size, each as a
    child process."""
    import os

    from dotaclient_tpu_torch.utils import telemetry
    from dotaclient_tpu_torch.utils.checkpoint import CheckpointManager, _to_cpu

    a, b = os.path.join(ckpt_dir, "league_a"), os.path.join(ckpt_dir, "league_b")
    CheckpointManager(a, registry=telemetry.Registry()).save(learner.state, learner.config, force=True)
    snap0 = learner.league.snapshots[0]
    CheckpointManager(b, registry=telemetry.Registry()).save_host(
        {"step": 0, "version": 0, "params": {k: v.cpu() for k, v in snap0.params.items()},
         "opt_state": _to_cpu(learner.state.optimizer.state_dict())}, learner.config, force=True)
    lines, cli_s = run_child(["dotaclient_tpu_torch.league", "--checkpoint", a, "--vs", b,
                              "--games", str(LEAGUE_CLI_GAMES)], "the league CLI")
    cli = json.loads(next(line for line in reversed(lines) if line.startswith("{")))
    if not (cli["games"] >= LEAGUE_CLI_GAMES and cli["opponent"] == f"checkpoint:{b}@step0"
            and cli["step"] == learner.state.step and 0.0 <= cli["win_rate"] <= 1.0):
        raise AssertionError(f"the league CLI's line {cli}")
    log(f"league CLI: {json.dumps(cli)} in {cli_s:.1f} s wall")
    lines, demo_s = run_child(["dotaclient_tpu_torch.train.demo", *DEMO_ARGS], "the demo")
    summary = json.loads(next(line for line in reversed(lines) if line.startswith("DEMO_SUMMARY "))
                         [len("DEMO_SUMMARY "):])
    rates = [v for k, v in summary.items() if "_win_" in k]
    flag = dict(zip(DEMO_ARGS[::2], DEMO_ARGS[1::2]))
    if not (summary["steps"] == int(flag["--steps"]) and summary["team_size"] == int(flag["--team-size"])
            and len(rates) == 5
            and all(0.0 <= r <= 1.0 for r in rates)):
        raise AssertionError(f"the demo's summary {summary}")
    log(f"demo {' '.join(DEMO_ARGS)}: DEMO_SUMMARY {json.dumps(summary)} in {demo_s:.1f} s wall")
    return {"cli": {**cli, "wall_s": cli_s}, "demo": {**summary, "wall_s": demo_s}}


def league_phase(device, seed, ckpt_dir):
    """The fused learner in league mode on the card: warm-up, the timed and
    checked iterations under the sync guard, a profiled window, then the
    evaluations and the two CLIs on its params."""
    import torch

    from dotaclient_tpu_torch.league import LIVE
    from dotaclient_tpu_torch.ops import lstm
    from dotaclient_tpu_torch.train.learner import Learner
    from dotaclient_tpu_torch.utils import telemetry

    cfg = league_config(seed)
    T = cfg.ppo.rollout_len
    updates = cfg.ppo.steps_per_batch * cfg.steps_per_dispatch
    learner = Learner(cfg, actor="fused", seed=seed, device=device, registry=telemetry.Registry())
    da, pool = learner.device_actor, learner.league
    rec = LeagueRecorder(learner)
    before = {k: v.detach().clone() for k, v in learner.policy.state_dict().items()}
    try:
        torch.cuda.synchronize()
        lstm.lstm_sequence_kernel.launches = 0
        learner.train(LEAGUE_WARM * updates)
        torch.cuda.synchronize()
        rec.clear()
        t0 = time.perf_counter()
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = learner.train(LEAGUE_TIMED * updates)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        launches = lstm.lstm_sequence_kernel.launches
        iters = LEAGUE_WARM + LEAGUE_TIMED
        if launches != iters * (2 * T + updates):
            raise AssertionError(f"lstm_seq launched {launches} times in {iters} league iterations, "
                                 f"expected {iters * (2 * T + updates)}")
        metrics = [{k: float(v) for k, v in m.items()} for m in rec.metrics]
        for i, m in enumerate(metrics):
            if not (np.isfinite(m["loss"]) and np.isfinite(m["grad_norm"]) and m["health_ok"] == 1.0):
                raise AssertionError(f"league iteration {i}: loss {m['loss']}, grad_norm {m['grad_norm']}, "
                                     f"health_ok {m['health_ok']}")
        frames = LEAGUE_TIMED * da.n_lanes * T
        if out["frames_trained"] != frames or len(metrics) != LEAGUE_TIMED:
            raise AssertionError(f"{out['frames_trained']} frames in {len(metrics)} iterations, expected {frames}")
        rollout_ms = statistics.mean(a.elapsed_time(b) for a, b, _ in rec.marks)
        update_ms = statistics.mean(b.elapsed_time(c) for _, b, c in rec.marks)
        # PFSP: each frozen opponent's record equals the league episodes
        # (and wins) of the calls that played it, read after the flush
        reports = [(uid, float(st["league_episodes"].sum()), float(st["league_wins"].sum()))
                   for uid, st in rec.reports]
        drawn = {uid for uid, _, _ in reports if uid != LIVE}
        played = {uid: sum(g for u, g, _ in reports if u == uid) for uid in drawn}
        for snap in pool.snapshots:
            if snap.uid in drawn:
                won = sum(w for u, _, w in reports if u == snap.uid)
                if (snap.games, snap.wins) != (played[snap.uid], won):
                    raise AssertionError(f"snapshot {snap.uid}: PFSP record {snap.games} games, {snap.wins} wins; "
                                         f"its calls reported {played[snap.uid]} and {won}")
        if not any(played[s.uid] > 0 for s in pool.snapshots if s.uid in drawn):
            raise AssertionError(f"no frozen draw in the pool played a full league episode: draws "
                                 f"{[u for u, _, _ in reports]}, league episodes {played}")
        if len(pool) < 2:
            raise AssertionError(f"{len(pool)} snapshot(s) in the pool")
        for snap in pool.snapshots:
            if not all(torch.equal(v, rec.witness[snap.uid][k]) for k, v in snap.params.items()):
                raise AssertionError(f"snapshot {snap.uid} (step {snap.step}) changed after it was taken")
        chunks, samples = list(rec.chunks), list(rec.samples)
        rec.close()
        profile = profiled(lambda: learner.train(LEAGUE_PROFILED * updates))
    finally:
        rec.close()
    moved, cast_legal, ability_choice = check_params_moved(before, learner.policy, chunks)
    if len(samples) != 2 * iters * T:
        raise AssertionError(f"{len(samples)} sample calls in {iters} league iterations, expected {2 * iters * T}")
    illegal, n_actions = [0, 0], [0, 0]
    for i, (masks, acts) in enumerate(samples):
        good = actions_legal(masks, acts)
        illegal[i % 2] += int((~good).sum())
        n_actions[i % 2] += good.numel()
    if any(illegal):
        raise AssertionError(f"illegal actions: learner lanes {illegal[0]} of {n_actions[0]}, "
                             f"opponent lanes {illegal[1]} of {n_actions[1]}")
    stats = da.drain_stats()
    if not stats["episodes_done"] > 0:
        raise AssertionError("no episode ended in the league phase")
    result = {
        "n_envs": cfg.env.n_envs, "team_size": cfg.env.team_size, "lanes": da.n_lanes,
        "opponent_lanes": da.n_opp_lanes, "anchor_games": da.n_anchor_games, "rollout_len": T,
        "updates_per_iteration": updates, "warm_iterations": LEAGUE_WARM, "timed_iterations": LEAGUE_TIMED,
        "frames_trained": frames,
        "frames_per_s": frames / wall_s,
        "iteration_ms": wall_s * 1e3 / LEAGUE_TIMED,
        "rollout_ms": rollout_ms,
        "update_ms": update_ms,
        "lstm_seq_launches": launches,
        "actions_checked": {"learner": n_actions[0], "opponent": n_actions[1]},
        "params_moved": sum(moved.values()), "params": len(moved),
        "frames_that_could_cast": cast_legal, "frames_with_a_choice_of_ability": ability_choice,
        "episodes_done": stats["episodes_done"], "win_rate": stats["win_rate"],
        "draws": [uid for uid, _, _ in reports],
        "snapshots": [{"uid": s.uid, "step": s.step, "games": s.games, "wins": s.wins} for s in pool.snapshots],
        "last_metrics": metrics[-1],
        "sync_debug_mode": "error",
        "profile": {"iterations": LEAGUE_PROFILED, **profile},
    }
    log(
        f"league: {LEAGUE_TIMED} timed fused iterations x {da.n_lanes} learner lanes (and {da.n_opp_lanes} "
        f"opponent lanes; {da.n_anchor_games} anchor games) x {T} steps = {frames} trained frames in "
        f"{wall_s * 1e3:.1f} ms: {result['frames_per_s']:.0f} frames/s, {result['iteration_ms']:.2f} ms an "
        f"iteration (rollout {rollout_ms:.2f} ms, update {update_ms:.2f} ms between CUDA events); no host sync "
        f"inside the iterations; loss {metrics[-1]['loss']:.4g}, health_ok 1 in all; {n_actions[0]} learner and "
        f"{n_actions[1]} opponent actions legal; {sum(moved.values())} of {len(moved)} param tensors moved; "
        f"{stats['episodes_done']:.0f} episodes; draws {result['draws']}; snapshots {result['snapshots']}, each "
        f"bitwise as taken; lstm_seq launches {launches}"
    )
    log_profile(f"league profile: {LEAGUE_PROFILED} iterations", profile)
    if pool.snapshots[0].step != 0:
        raise AssertionError("the step-0 snapshot left the pool before the league evaluation")
    evals = {"scripted_hard": counted_eval(learner, "scripted_hard", None, seed, device),
             "league": counted_eval(learner, "league", pool.snapshots[0].params, seed, device)}
    result["eval"] = {**evals, "lstm_seq_launches": sum(e["lstm_seq_launches"] for e in evals.values())}
    result["children"] = league_children(learner, ckpt_dir)
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
    serve_profile = profile_serve(device, args.seed)
    lstm_extra["backward"] = check_lstm_backward(device, args.seed)
    train, learner, chunk = train_phase(device, args.seed)
    train["kernel_vs_plain"] = check_train_step_kernel(learner, chunk)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_") as ckpt_dir:
        sock = socket_phase(device, args.seed, learner, ckpt_dir, serve)
        sock["cli"] = cli_phase(ckpt_dir, learner.state.step, args.seed)
        fleet = {"parity": fleet_parity_phase(device, args.seed, ckpt_dir),
                 "cli": fleet_cli_phase(ckpt_dir, learner.state.step, args.seed)}
        league = league_phase(device, args.seed, ckpt_dir)
    lstm_entry["launches_by_path"] = {"serve": serve["lstm_seq_launches"], "train": train["lstm_seq_launches"],
                                      "serve_socket": sock["lstm_seq_launches"],
                                      "serve_fleet_parity": fleet["parity"]["lstm_seq_launches"],
                                      "serve_fleet_processes": fleet["cli"]["lstm_seq_launches"],
                                      "train_league": league["lstm_seq_launches"],
                                      "league_eval": league["eval"]["lstm_seq_launches"]}
    lstm_entry["launches"] = sum(lstm_entry["launches_by_path"].values())

    kernels = {"kernels": [lstm_entry]}
    if args.out:
        with open(args.out, "w") as f:
            json.dump({**kernels, "lstm_seq_extra": lstm_extra, "serve": serve, "build_s": build_s, "card": smi,
                       "profile": serve_profile, "train": train, "socket": sock, "fleet": fleet,
                       "league": league}, f, indent=2)
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
