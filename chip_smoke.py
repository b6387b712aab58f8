#!/usr/bin/env python3
"""Drive the PyTorch port's serving, training, league, buffered-learner, run-record, external-actor, scalar, transformer, wire, data-parallel and multi-GPU paths, the tools beside the package, the static checks, the preflight and the gate, the bench, and the wide LSTM core on the grid-wide kernel, on one NVIDIA card, end to end.

Run from the root of a checkout, on a machine with a CUDA card:

    python3 chip_smoke.py [--seed 0] [--out results.json]

Phases (each one's seconds logged on a line of their own; any failure
exits non-zero and prints no result line):

1. build: compile every kernel of the path (``ops/csrc/*.cu``, sm_90a)
   from the sources in this checkout;
2. kernels: each kernel against its plain PyTorch version on the card, on
   seeded random inputs at every shape the port gives it (for the LSTM:
   the serving step B=64 T=1, the learner's sequence B=32 T=16, the test
   shape, a batch with a partial row tile, the training path's B=128 at
   T=1 and T=17, the parity digest's B=1 T=1, the 5v5 league's B=1,280
   at T=1 and T=17, its 64-game evaluation's B=320 T=1, and the buffered
   learner's advantage pass B=32 T=17 and minibatch updates B=16 at T=16
   (on precomputed advantages) and T=17 (the in-step estimator), the
   scalar pool's step B=8 T=1, a world-2 rank's update B=64 T=17, and phase
   21's: the 256 self-play lanes of BASELINE configs 3 and 4 at B=256 T=1
   and T=17, config 2's 512 at B=512 T=1, phase 12's demo's update B=320
   T=17, the curriculum's B=8 T=17 and
   B=40 at T=1 and T=17, and the chaos children's B=4 T=1, B=8 T=9 and
   B=4 T=8; and phase 22's: the fused parity ranks' B=2 and B=4 at T=1
   and T=9, the router failover digest's B=1 T=1 at D=H=8; and phase 23's:
   the advantage stage's pass B=64 T=5 and updates B=32 at T=4 and T=5,
   its parity digest's B=8 T=8 and the serve curve's B=16 T=1), with the f32
   tolerance stated below, its launch plan logged, and timed on the card (CUDA
   events around a CUDA graph of 100 calls, median of 11 replays; warm)
   beside its plain version, the one PyTorch call that computes the same
   function (``torch.lstm_cell`` at T=1; at T>1 cuDNN's ``torch.lstm`` on
   a reset-free copy, a labelled yardstick only) and its roofline bound;
   the time of a single call with the host's issue included (events
   around each call, median of 200) is logged too. Every one of those
   shapes must take the cluster plan. Then the grid-wide kernel, at
   LSTM_GRID_SHAPES (shapes the cluster plan refuses: phase 24's serving
   step B=64 T=1, rollout step B=128 T=1 and update B=128 T=17 at
   D=H=512; H=256 and 1,024 at B=64 T=1; an odd width, B=5 T=3 at H=255;
   and H=128 past the cluster's T, B=4 T=10,000), each of which must take
   the grid plan, held against the plain version and timed the same way
   (graphs of ~50 ms where a call is long: one call and 3 replays at
   T=10,000, where the plain version is timed around one call, the host's
   issue included), with ``torch.lstm_cell`` at T=1 and cuDNN's reset-free
   ``torch.lstm`` at 1 < T < 1,000. Where K = D+H exceeds 256 (no cluster shape of the port's paths
   does) the tolerance is ``wide_atol``'s: KERNEL_ATOL, or twice the plain
   version's own max abs error against the same function in f64 on the
   same inputs, whichever is larger. Then the grid kernel's bits at the
   wide core: two launches at the serving step equal, row 0 of it equal to
   a B=1 launch, and a T=1 launch at the training batch equal to step 0 of
   a T=17 launch;
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
   kernels in a torch.profiler window of 1 more iteration;
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
    1 more iteration under the profiler. Then, on its params:
    ``evaluate`` against ``scripted_hard`` and (league mode) against the
    step-0 snapshot, 64 games each (episodes >= games, win rate in [0, 1],
    ``lstm_seq`` launches = the policy steps it ran, wall time logged);
    ``python -m dotaclient_tpu_torch.league`` as a child on a checkpoint of
    the phase with ``--vs`` on a second; and ``python -m
    dotaclient_tpu_torch.train.demo`` as a child at a smoke size. Each
    child must exit 0 with its result line; every wait is bounded and every
    child is killed in a ``finally``.
13. buffered: ``Learner(cfg, actor="device")`` on the default ``RunConfig``
    at phase 6's traffic (128 games against the easy bot, 20 s games) with
    ``epochs_per_batch`` 2 and ``minibatches`` 2 over the default batch of
    32 chunks and ring (256 chunks, ``min_fill`` 32), so the one-pass
    advantage pass and the epoch step both run, the health guardian and the
    snapshot engine on, and a checkpoint directory: 1 warm collect, 4
    timed ones and one that meets the first log and checkpoint boundary,
    each ``train`` call's loop under ``torch.cuda.set_sync_debug_mode
    ("error")`` (the boundary's copies to the host held by the engine until
    the guard lifts; the end of each call, with its forced save, runs
    unguarded), and 1 more collect under the profiler. Checked: finite
    loss and gradient norm and ``health_ok`` 1 in every batch, every param
    moved, every action legal, episodes ended, the ring's books (ingested =
    collects x 128 = batches x 32 + size + each kind of drop),
    ``advantage/passes_total`` = batches, one log line and the ``last_good``
    slot at the boundary with no engine error, and ``lstm_seq`` launched
    collects x ``rollout_len`` + passes + batches x 4 times in that run (its
    counts reset just before it and read just after). Logged: trained
    frames/s and wall ms a collect and a batch (the loop's host clock), a
    collect and a batch's updates between CUDA events, ``snapshot/d2h_ms``,
    ``learner/stall_fraction``, the busy share and top kernels, beside
    phase 6's fused frames/s. Then a rollback (the 9th batch of a run with
    boundaries every 20 steps poisoned by ``learner.nan_grad``: one
    HEALTH_ROLLBACK line back to step 20, a refused checkpoint, the params
    bitwise equal to the ``last_good`` slot, the poisoned chunks dropped,
    the run at its target step), a resume (``request_stop`` at step 24,
    then ``restore=True``: ring, slot versions, actor state and RNG,
    ``mb_draws`` and params bitwise as saved, the next permutation an
    uninterrupted run's), and ``python -m dotaclient_tpu_torch.train.learner
    --smoke --steps 3 --metrics-jsonl`` as a child with the default actor
    (exit 0, its ``done:`` line, its record's last line).
14. run record: (a) ``python -m dotaclient_tpu_torch.train.learner`` as a
    child at phase 13's traffic on the default config (128 games, 16
    steps, a periodic save every 8) with ``--metrics-jsonl``, ``--logdir``
    and ``--profile``: its record against the schema's base tier and its
    snapshot, health, trace, advantage, fleet, outcome and utilization
    tiers (``utils/schema.py``), ``mem/hbm_peak_bytes`` inside the card's
    memory, ``--logdir``'s one warning where tensorboardX is missing, the
    profile's Chrome trace holding the 80 ``lstm_seq`` kernels the run
    launched, the periodic saves and the final one with its pipeline;
    (b) beside it, the same child with ``learner.fail_train_step`` on its
    11th update and ``--on-crash-checkpoint``: a non-zero exit, the error on
    stderr, the crash save's line and its step verified by its manifest,
    then a ``--restore`` child that trains on from it and exits 0; (c) in
    this process, on phase 13's buffered learner: ``CheckpointManager.save``
    returning against ``wait`` landing for the train state alone and with
    the pipeline, and the forced end-of-train save's two halves, printed
    with the card's name and power limit; (d) that learner's 8 collects with
    a log line each and ``checkpoint_best_min_episodes`` cut to 16 (from
    50): ``best/`` and ``best_meta.json`` at the highest qualifying window,
    ``init_from`` it loading those weights bitwise, and the outcome curves
    off their priors at the totals' rate once games end; ``lstm_seq``
    launched collects x ``rollout_len`` + passes + batches x 4 times there
    (its counts reset just before and read just after).
15. external actors, BASELINE config 2: (a) ``Learner(cfg, actor="vec")``
    on the default ``RunConfig`` with 64 self-play games (team size 1: 128
    lanes) of 20 s, in process: 2 warm and 8 timed optimizer steps
    alternating with the pool, 4 more under the profiler, then 8 with
    ``overlap=True`` (the pool on its own thread). Checked: finite loss
    and ``health_ok`` 1, every param moved, ended episodes, the ring's books
    (ingested = batches x 32 + size + stale + overflow drops; skew,
    non-finite and bounds drops 0), and ``lstm_seq`` launched pool steps +
    updates times in the sequential run (its counts reset just before and
    read just after). Logged: trained frames/s, the pool's env steps/s,
    ``span/actor/infer``, the busy share. (a') a second vec learner, built
    after this process's tracer is configured at sample 1, for
    VEC_TRACED optimizer steps with its train loop under
    ``torch.cuda.set_sync_debug_mode("error")``: the learner-side hops
    (the ring's ``admit`` after its ``index_copy_``, ``gather`` at
    ``take``, ``dispatch`` after the epoch step) run beside the card's work
    with the guard on; the pool's steps (its copies to and from the card,
    by design) and the end of ``train`` run with it lifted, and the
    snapshot engine's copies wait for the lift. Checked: at least one
    chunk timeline, every complete one with hops collect <= encode <=
    admit <= gather <= dispatch, ``trace/dropped_total`` 0, ``lstm_seq``
    launched (counts reset just before, read just after). (b) ``python -m
    dotaclient_tpu_torch.train.learner --actor external --transport socket
    --listen 127.0.0.1:PORT --metrics-jsonl`` as a child at the reference's
    CLI defaults (batches of 32, 1 x 1 updates, ``--refresh-every`` 10)
    with ``--buffer max_weight_staleness=20`` (at the default staleness
    limit of 4 steps, publishes every 10 steps starve the learner at its
    5th step after a publish, in the JAX package too) for EXTERNAL_STEPS
    steps, fed by EXTERNAL_ACTORS ``python -m dotaclient_tpu_torch.actor
    --connect 127.0.0.1:PORT --n-envs 64 --opponent selfplay --max-dota-time
    20 --platform cuda`` children. One actor gets SIGKILL at the learner's
    step-20 line, the others SIGTERM at its step-30 line; they must flush
    and exit 0 while it runs, and the learner must go on to its ``done:``
    line. Checked: each surviving actor's closing lines (weights versions
    above 0 applied, ``lstm_seq`` launched once a pool step), the record's
    ``transport/rollout_bytes_total`` above 0, skew, non-finite and
    malformed drops 0, the chunks' versions above 0 (the last batch's
    staleness below its step), and ``lstm_seq`` launched updates + advantage
    passes times in the learner child (its ``done:`` line). Logged: trained
    frames/s, rollouts ingested a second, stale drops, each actor's chunks
    and env steps/s, ``learner/publish_stall_ms``, the phase's wall time
    split into the children's starts and the steps, and the learner's
    window between its step-10 and step-20 lines: its train thread's spans
    and ``util/phase/*`` shares from its record, and the CPU cores the
    learner process, its train thread and the actors used (``/proc``).
    The learner and the actors run ``--fleet-interval 1``; on the learner's
    last record line before the kill (its step-20 line) the fleet plane is
    held: ``fleet/peers`` equal to the live peers, each actor's
    ``fleet/a<seed>/util/actor/{env_step,featurize,encode,ship_wait,other}``
    present, each in [0, 1] and folded (summing to 1 within 0.01), and
    ``outcome/win_rate/overall`` off its prior (the window holds at least 8
    episodes), logged with the card's name and power limit. The run is
    untraced, so its frames/s stays comparable across runs.
    Every child is killed in a ``finally``.
16. the scalar path, BASELINE config 1, and the shm lane: where ``grpc`` is
    installed (``importlib.util.find_spec``; printed either way), one
    reset/act/observe cycle of the gRPC fake dotaservice over 127.0.0.1.
    (a) ``Learner(cfg, actor="scalar")`` at the reference's defaults
    (``RunConfig()``: 8 games against the easy bot, hero Shadow Fiend,
    LSTM(128), batches of 32, 1 x 1 updates) with games of 20 s: 1 warm and
    3 timed optimizer steps alternating with the scalar pool, then 3 with
    the pool on its own thread, while (a')'s children run beside it. Checked: finite loss and ``health_ok`` 1,
    every param moved, every trained action legal, ended episodes, chunk
    versions above 0 (the pool plays pushed params), the ring's books, and
    ``lstm_seq`` launched pool steps + updates + advantage passes times
    (counts reset just before and read just after). Logged: trained
    frames/s, the pool's env steps/s, ``span/actor/step`` against
    ``span/actor/infer``. (a') ``python -m dotaclient_tpu_torch.train.learner
    --actor scalar --checkpoint-dir --metrics-jsonl`` for 10 steps and, beside
    it, ``--no-vec`` for 10: exit 0, their ``done:`` lines' launches against
    pool steps + updates + passes from their records. (b) ``evaluate_served``
    in this process: 8 games against the hard bot, games of 20 s, through a
    ``python -m dotaclient_tpu_torch.serve`` child on (a')'s checkpoint
    (episodes >= 8, a win rate in [0, 1], the child's launches = its
    dispatches, SIGINT, exit 0), every request traced: the child with
    ``--trace-jsonl``, this process's tracer at sample 1 around the games
    under the sync guard; every request's timeline joins with hops
    encode <= recv <= reply <= done, one a request the server counted, and
    the median server share of the round trip is logged. (c) phase 15 (b)'s
    topology on the shm
    lane: the learner CLI with ``--transport shm --shm-name NAME``, the
    actor CLIs with ``--connect shm://NAME``, the same steps, kill, stop and
    staleness window, and a serve CLI child with ``--subscribe shm://NAME``
    on (a')'s checkpoint that must apply a version the learner published.
    Checked as phase 15 (b) (the fleet plane's peers include the serve
    CLI), and the SIGKILLed actor's slot reaped
    (``shm/slots_reaped``) and no segment or lockfile of NAME left in
    /dev/shm after the phase (the phase unlinks any it finds, and fails).
    The learner and the actors run with ``--trace-jsonl`` at the default
    sample of 16, and ``utils/trace_report.py`` joins their logs: at least
    one complete chunk timeline, every complete one with hops collect <=
    encode <= recv <= consume <= admit <= gather <= dispatch,
    ``trace/dropped_total`` 0 (the learner's, and each actor's fleet row),
    and an ``apply`` event with a publish stamp in each surviving actor's
    log. Logged as phase 15 (b), with the ring-full drops, the ratio of the
    trained frames/s to phase 15 (b)'s in the same run, and the median ms of
    each leg (wire, decode, ring residency, gather -> dispatch, publish ->
    apply) with the card's name and power limit.
17. the transformer and MoE cores (``ModelConfig(core="transformer")`` at
    the reference's widths: H 128, 2 layers, 4 heads, a window of 16, bf16
    compute, f32 params; no kernel of its own, so ``lstm_seq`` must launch
    0 times on this path, which shows the core switch took). (a) BASELINE
    config 5 at phase 12's league shape and cuts (256 5v5 games, 1,280
    learner and 1,280 opponent lanes): 1 warm and 4 timed fused iterations
    under the sync guard, 1 profiled. Checked: finite loss and
    ``health_ok`` 1, params moved, both sides' actions legal, snapshots
    bitwise as taken, the chunks' and both sides' carry leaves (valid [L,
    16], k and v [L, 16, 128] a layer, f32). Logged: trained frames/s and
    its ratio to phase 12's LSTM league in the same run, rollout and update
    ms (CUDA events), kernels and copies an iteration and the busy share
    (profiler); then one 64-game evaluation against the hard bot. (b) 4
    Switch experts a layer (capacity factor 2), fused at 128 games of 1v1
    against the easy bot (the demo's recipe, 20 s games): 1 warm and 2
    timed iterations under the sync guard; ``moe_aux`` finite and above 0
    in each, the actions legal; the share of tokens dropped at capacity per
    layer logged (the last chunk's sequence forward), while (c) starts
    beside it. (c) ``python -m
    dotaclient_tpu_torch.train.learner --core transformer --smoke --steps 4
    --checkpoint-dir`` as a child: its ``done:`` line (4 steps, 0
    launches), the checkpoint's step and core, a ring of its config holding
    [W] and [W, H] carry leaves. (d) ``python -m dotaclient_tpu_torch.serve``
    on (c)'s checkpoint with ``--serve carry_shadow=true``: 16 ``ServeClient``
    games x 10 steps over TCP, every action legal, shadow rows named c0..c4,
    each step replayed on the CPU from the row the server shadowed the step
    before (the bounds and controls at ``SOCKET_LOGP_ATOL``), SIGINT, exit 0,
    0 launches in its last line.
18. the wire: the rollout codec runs native in every process (the port's
    C++ codec, built at first use into ``native/_build/``): each learner
    CLI's ``done:`` line, each actor's ``ACTOR_STATS`` and each serve CLI's
    last line count its calls by path, and any protobuf fallback fails the
    run, as it does in this process at the end. (a) the chunks one pool
    phase of a ``VecActorPool`` ships at BASELINE config 2 (64 self-play
    games, 128 chunks), encoded and decoded CODEC_REPS times by the native
    codec and by protobuf, at f32 and on the bf16 wire: payloads/s and MB/s
    of each (host clock), a chunk's bytes at each width, the bf16 leaves'
    one copy at decode; checked: native bytes parse to protobuf's message,
    both decodes give the same arrays, every call native. (b) phase 15 (b)'s
    topology over TCP with ``--rollout-wire-dtype bfloat16`` on the learner
    CLI and its 8 actors and ``--wire-dtype bfloat16`` on the learner,
    WIRE_STEPS steps, the actors stopped at the step-20 line (no kill);
    checked: ``transport/rollout_compression_ratio`` above 1.5, the ring's
    resident bytes those of the narrow layout, every actor applied bf16
    weights frames, loss finite and ``health_ok`` 1, the codec's calls
    native, ``lstm_seq`` = updates + passes; logged with phase 15 (b)'s
    frames/s of the same run. (c) the buffered learner with
    ``transport.rollout_wire_dtype="bfloat16"`` in process, NARROW_COLLECTS
    collects under the sync guard: the ring's store bf16, int8 and int16,
    ``lstm_seq`` as phase 13 derives it; then a collect's chunk into a
    narrow ring and, widened, into an f32 ring, whose takes must be equal
    bit for bit; and a bf16 weights frame through the shm slab, equal to
    the params rounded to bf16. AMQP is not driven here: neither machine
    has ``pika`` (its tests run on a fake broker).
19. data parallel over ``torch.distributed``, (a) as a child beside (b)
    in this process: (a) ``python -m
    torch.distributed.run --standalone --nproc-per-node 1 --no-python
    python -c ...`` running the learner CLI's ``main`` (``--multihost
    --mesh data_parallel=-1``) at phase 14's traffic for DP_CLI_STEPS
    steps, every ``train`` call's loop under the sync guard once the
    learner is built (``dp_guarded_learner``): its runtime line (world 1
    over NCCL), its ``done:`` line's ``lstm_seq`` launches, and its record
    against every learner tier, the multichip one among them (``mesh/*`` 1,
    ``learner/psum_ms`` above 0). (b) two spawned ranks on the one card
    over gloo (NCCL refuses two ranks on a device), each a fused
    ``Learner`` at phase 6's traffic (64 of the 128 games a rank), DP_WARM
    + DP_TIMED iterations, beside a world of 1 in this process: the first
    chunk, the ranks' shards concatenated, bit for bit world 1's; the
    ranks' params bit for bit equal, after the first update and the last;
    the first update against world 1's by the CPU tests' rule (the loss
    within DP_RTOL, at most DP_MAX_PAST of the param elements past DP_RTOL;
    ``grad_norm`` within DP_GRAD_RTOL, two bf16 roundings of the gradient); ``lstm_seq`` launched iterations x (rollout_len + 1)
    times on each rank. Logged for information: the params' distance from
    world 1's after every iteration, both runs' frames/s and the update's
    all-reduces' share of the loop (gloo's CUDA all-reduce goes through the host, so (b) runs
    without the sync guard; two ranks on one card say nothing of scaling).
    The collective primitives (ring and Ulysses attention, the pipeline,
    the expert dispatch) are not driven here: on one card a world above 1
    needs gloo, which has no CUDA send, receive or all-to-all; their
    evidence is the CPU tests.
20. the rest of multi-GPU (``multigpu_rest_phase``): two spawned ranks on
    the one card over gloo, each part against world 1 in this process.
    (a) the ``external`` learner fed the same 160-chunk stream (drawn
    with numpy from the seed, mixed versions) through rank 0's in-process
    transport: the ring's single door on rank 0, a stale drop and 32
    evictions between admission and take; every batch, the ranks' shares
    joined, bit for bit world 1's, rank 0's books world 1's, each rank's
    ``buffer/shard_bytes`` half world 1's, rows crossing shards counted,
    the first update by 19 (b)'s rule, the ranks' params bitwise equal;
    both loops under the sync guard, lifted (and counted) only around
    gloo's all-reduces and broadcasts of CUDA tensors and the door's row
    moves (``TrajectoryBuffer._move_rows``). Then the ``vec`` learner for
    MG_VEC_STEPS updates: rank 0's ``lstm_seq`` launches its pool steps
    plus its updates, rank 1's its updates alone. (b) the MoE transformer
    (4 experts, capacity factor MG_MOE_CF) fused at data 2, with cuBLAS's
    reduced-precision bf16 reductions off in both worlds (with them on, a
    bf16 GEMM's reduction split may change with its rows, and the
    transformer's rollout at 32 lanes a rank is not world 1's at 64): the
    first chunk bitwise, each layer's kept and routed tokens an expert over the first
    iteration (the ranks' summed) equal to world 1's with tokens dropped,
    the first update by 19 (b)'s rule and ``moe_aux`` within 1e-4. (c)
    LSTM(128) fused at data 1 x model 2: ``trunk_proj``'s stored master the
    cut shape, the gathered params bitwise equal on both ranks, the first
    update's loss and ``grad_norm`` within 1e-4 of world 1's, the params
    after MG_TP_ITERS iterations within rtol 2e-4, atol 2e-5, and
    ``lstm_seq`` iterations x (rollout_len + 1) on each rank.
21. the tools beside the package (``tools_phase``), within
    PHASE21_BUDGET_S. (a) every BASELINE config through
    ``train/bench_configs.py``'s ``measure_config`` (its config, its
    ``Learner``, its frames_trained over the host clock), configs 3 and 4
    in the ``device`` and ``fused`` modes, 1, 2 and 5 in ``device``, cut to
    games of BENCH_MAX_DOTA_TIME, BENCH_WARMUP warm-up step and one block
    of BENCH_STEPS: frames/s, learner lanes (games x heroes, x 2 in
    self-play: 256 for configs 3 and 4, 512 for config 2), finite loss
    and ``health_ok`` 1 in every update, every param moved, every action legal, ``lstm_seq``
    launched as the iterations derive (a rollout step once a side; a fused
    iteration's update once; a buffered batch's update and advantage
    passes), each launch at a shape phase 2 holds against the plain
    version; the fused frames/s of configs 3 and 4 logged against phase
    6's. Beside (a), started beside phase 20, (b) ``python -m
    dotaclient_tpu_torch.train.curriculum`` as a child (CURRICULUM_ARGS):
    exit 0, a ``DEMO_SUMMARY`` a stage, stage 2 from stage 1's saved step
    and its checkpoint bit for bit stage 1's in every param but the value
    head (its critic-only warm-up trains that alone); (c) ``python -m
    dotaclient_tpu_torch.utils.chaos_run --scenario baseline`` as a child
    with 2 actors, the SIGTERM at step CHAOS_STEPS and as many after the
    restore: ``CHAOS_SUMMARY`` ok, both learners exit 0, an actor killed,
    corrupt frames counted, the exact resume, each learner's ``lstm_seq``
    launches (its ``done:`` line) its steps plus its advantage passes (its
    record).
22. the checks and the preflight (``checks_phase``), within
    PHASE22_BUDGET_S, children side by side. (a) ``python -m
    dotaclient_tpu_torch.utils.run_multichip`` (the preflight: the card's
    init with no pin, then the dry run's global-batch update at world 1
    over NCCL) must print ``"ok": true``; a SKIP line fails the phase; its
    ``--fused-parity 2`` (world 1 against two ranks on the card over gloo:
    losses, float64 param L1, the lane split read off each rank's actor
    state) runs once, as phase 23's fused_multichip stage, and is checked
    there. (b) the learner CLI with ``--checkify`` at the ``--smoke``
    sizes for CHECKIFY_STEPS steps: the clean child's final checkpoint
    against an unchecked child's from the same seed, every tensor bitwise
    (the checks read results and change none), a child
    poisoned by ``DOTA_FAULTS=learner.nan_grad@1`` exits non-zero naming
    the op, and the seconds an update of both clean children. (c) two
    learner children with the same fresh ``--compile-cache DIR``, one after
    the other: the first builds the kernel library and the codec into
    DIR, the second loads both with no build (the libraries' mtimes
    unchanged); both children's build seconds logged. (d) ``bash
    dotaclient_tpu_torch/utils/ci_gate.sh`` with ``CI_GATE_SKIP_TESTS=1``:
    every stage passes on the card. Every child but the second compile
    cache learner starts beside phase 21.
    Every child runs with SHAPE_SHIM as its ``sitecustomize``: every
    process it starts counts the shape of each ``lstm_seq`` launch in
    memory and writes the counts at its exit; each shape must be in
    LSTM_SHAPES, and the kernels line counts them.
23. the bench (``bench_smoke_phase``): ``python -m
    dotaclient_tpu_torch.bench --smoke`` on the card (the learner's
    ``--smoke`` sizes at the default model's widths, a few steps a variant;
    the advantage stage's E=16 M=2 T=4 B=64 and the serve curve's 16
    clients as the stage defines them), its headline and thirteen stages
    split over BENCH_CHILDREN, three children started beside phase 21, each
    with SHAPE_SHIM and an anchor file of its own. Checked: each child
    exits 0 with one JSON line and no stage's ``error``; the parity digests
    (multichip, advantage, serve, the re-home, the fused parity) and
    ``serve_fleet_complete`` at 1; ``rollout_compression`` at least 1.8;
    every frames/s in the lines finite and above 0; nothing of a child's
    session left running; every ``lstm_seq`` shape its processes launched
    in LSTM_SHAPES; the fused_multichip stage, phase 22 (a)'s fused parity
    at 2, on the card with the lanes split 2 + 2. Logged: the lines'
    numbers, which at this depth check the path and measure nothing (the
    reference's depth runs stage by stage outside this script).
24. the wide core (``wide_core_phase``): the LSTM at ``ModelConfig(
    hidden_dim=512)``, every other field at its default (``unit_embed_dim``
    64, bf16 compute), a width whose weight slice no cluster holds, on the
    grid-wide kernel. (a) phase 6's traffic: the fused learner at 128
    games against the easy bot, WIDE_WARM warm-up, WIDE_TIMED timed
    iterations under the sync guard and WIDE_PROFILED under the profiler
    (the rollout step B=128 T=1, the update B=128 T=17). Checked: finite
    loss and ``health_ok`` 1 in the timed iterations, every param moved,
    every action legal, and the grid plan's launches iterations x
    (rollout_len + updates) with none of the cluster plan's (the counts
    reset just before, read just after). (b) phase 3's serving traffic
    (64 games x 20 steps, B=64 T=1, a release and a weight swap) on a
    ``ServeEngine`` at that width: every request answered legally, the
    grid plan's launches equal to the dispatches and the cluster's 0, the
    stream replayed bitwise through ``reference_step``, and each reply's
    log-prob against the same policy with ``use_kernel=False`` on the card
    (the plain version's carries chained, the served actions scored)
    within SOCKET_LOGP_ATOL, while the same replay with the carries zeroed
    at every dispatch must read above it. Logged: trained frames/s,
    rollout and update ms, the busy share; req/s and p50/p99.
    Phase 24 runs after phase 21, beside the children of phases 22 and 23
    (so its times are taken beside theirs), and the grid plan's launches in
    this process stay at phase 2's from its end to phase 24: the H=128
    paths launch only the cluster plan.

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
# phase 17 (d)'s replay of the bf16 transformer from the served carry rows:
# its core rounds to bf16 some 40 times a layer where the LSTM's runs in
# f32, so a sound request lands above SOCKET_LOGP_ATOL now and then (a
# logit one bf16 ulp apart). Its 95th percentile is held to
# SOCKET_LOGP_ATOL and every request to SERVE_LOGP_ATOL, and the same run's
# controls (each step from another game's row or from a zero row) must read
# above SERVE_LOGP_ATOL
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
TRAIN_WARM, TRAIN_TIMED, TRAIN_PROFILED = 2, 8, 1

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
LEAGUE_EVAL_GAMES, LEAGUE_CLI_GAMES = 64, 8

# phase 13's buffered learner: the default batch of 32 chunks, split into
# 2 minibatches in each of 2 epochs
BUFFERED_BATCH, BUFFERED_EPOCHS, BUFFERED_MINIBATCHES = 32, 2, 2
BUFFERED_MB = BUFFERED_BATCH // BUFFERED_MINIBATCHES

# (B, T, D, H): the serving step, the learner's sequence, the small test
# shape, a batch that leaves one partial row tile, the fused training
# path's two (the rollout step over 128 lanes and the update's sequence
# forward, rollout_len 16 plus the bootstrap step), the re-home parity
# digest's step (max_batch 1), the 5v5 league's two (1,280 learner lanes,
# and as many opponent lanes, at T=1; the update at T=17), the league
# evaluation's step (its games' learner lanes, and in league mode as many
# opponent lanes, at T=1), and the buffered learner's three: the one-pass
# advantage pass over a batch (B=32 T=17, forward only), a minibatch's
# update on precomputed advantages (B=16 over the T=16 transition steps,
# the path phase 13 runs) and a minibatch's update with the in-step
# estimator (B=16 T=17: one_pass_advantage off, or V-trace), and the
# scalar pool's step (BASELINE config 1: the default 8 games against a
# scripted bot, one lane each, at T=1), and phase 19's rank of a world of
# 2 (64 of the 128 games) at the update (its rollout step is the serving
# step's shape); then phase 21's: BASELINE configs 3 and 4's 256 self-play
# learner lanes at the rollout step and the fused update, config 2's 512
# (256 games) at the rollout step (the buffered modes' update is the
# advantage pass's B=32 T=17), phase 12's demo child's update (64 5v5
# games: B=320 T=17; its and the league CLI's 8-game evaluations are the
# curriculum's B=40 T=1), the curriculum's stages at 8
# games (stage 1's fused update B=8 T=17; stage 2's 40 lanes of 5v5 at the
# step, its 8-game evaluations, and the update), and the chaos baseline's
# children: an actor's 4 games at the step, and the learner's batch of 8
# chunks of 8 steps at the advantage pass (T=9) and its minibatches of 4 at
# the update on precomputed advantages (T=8); then phase 22's: the fused
# parity probe's 4 games (world 1) and a world-2 rank's 2 at the step and
# the fused update (T=9), and the router failover digest's tiny backends
# (D=H=8) at the serving step B=1; then phase 23's: the advantage stage's
# headline shape (E=16 M=2 T=4 B=64: the pass at B=64 T=5, a minibatch's
# update at B=32 on precomputed advantages, T=4, and with the in-step
# estimator, T=5), its parity digest's update on precomputed advantages at
# the --smoke batch (B=8 T=8), and the serve curve's 16 clients (B=16 T=1)
LEAGUE_LANES, LEAGUE_EVAL_LANES = LEAGUE_ENVS * LEAGUE_TEAM, LEAGUE_EVAL_GAMES * LEAGUE_TEAM
SCALAR_LANES = 8
SELFPLAY_LANES, CONFIG2_LANES, CURRICULUM_5V5_LANES = 256, 512, 8 * 5
LSTM_SHAPES = ((64, 1, 128, 128), (32, 16, 128, 128), (5, 3, 16, 32), (65, 2, 128, 128),
               (128, 1, 128, 128), (128, 17, 128, 128), (1, 1, 128, 128),
               (LEAGUE_LANES, 1, 128, 128), (LEAGUE_LANES, 17, 128, 128), (LEAGUE_EVAL_LANES, 1, 128, 128),
               (BUFFERED_BATCH, 17, 128, 128), (BUFFERED_MB, 16, 128, 128), (BUFFERED_MB, 17, 128, 128),
               (SCALAR_LANES, 1, 128, 128), (TRAIN_ENVS // 2, 17, 128, 128),
               (SELFPLAY_LANES, 1, 128, 128), (SELFPLAY_LANES, 17, 128, 128), (CONFIG2_LANES, 1, 128, 128),
               (LEAGUE_EVAL_LANES, 17, 128, 128), (8, 17, 128, 128),
               (CURRICULUM_5V5_LANES, 1, 128, 128), (CURRICULUM_5V5_LANES, 17, 128, 128), (4, 1, 128, 128),
               (8, 9, 128, 128), (4, 8, 128, 128), (2, 1, 128, 128), (2, 9, 128, 128), (4, 9, 128, 128),
               (1, 1, 8, 8), (64, 5, 128, 128), (32, 5, 128, 128), (32, 4, 128, 128), (8, 8, 128, 128),
               (16, 1, 128, 128))

# phase 24's wide core: ModelConfig(hidden_dim=WIDE_HIDDEN), every other
# field at its default; the learner's warm-up, timed and profiled
# iterations
WIDE_HIDDEN = 512
WIDE_WARM, WIDE_TIMED, WIDE_PROFILED = 1, 2, 1
# (B, T, D, H) of the grid-wide plan, shapes the cluster plan refuses:
# phase 24's serving step, rollout step and update at D=H=512, the serving
# step at H=256 and at H=1,024 (whose weight slice is read from L2 each
# step), an odd width, and H=128 past the cluster plan's T (its tile's
# resets sit whole in shared memory)
LSTM_GRID_SHAPES = ((64, 1, WIDE_HIDDEN, WIDE_HIDDEN), (TRAIN_ENVS, 1, WIDE_HIDDEN, WIDE_HIDDEN),
                    (TRAIN_ENVS, 17, WIDE_HIDDEN, WIDE_HIDDEN), (64, 1, 256, 256), (64, 1, 1024, 1024),
                    (5, 3, 255, 255), (4, 10_000, 128, 128))


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


def wide_atol(args, want):
    """The kernel's tolerance against the plain version where K = D+H
    exceeds 256 (no cluster shape of the port's paths does), and the plain
    version's own max abs error against the same function in f64: the
    larger of KERNEL_ATOL and twice that error. Both f32 evaluations sum
    512-2,048 products a gate in different orders, and at these inputs
    (weights of std 0.3, 6.8x the policy's lecun scale at H=512) each step
    of the recurrence amplifies the rounding of the steps before (H100:
    1.45e-4 between kernel and plain at B=128 T=17 H=512, the plain version
    itself 1.25e-4 from f64); the plain version's own error measures that
    amplification on the same inputs."""
    from dotaclient_tpu_torch.ops import lstm

    exact = lstm.lstm_sequence_reference(*(a.double() for a in args))
    own = max(float((a.double() - b).abs().max()) for a, b in zip((want[0], *want[1]), (exact[0], *exact[1])))
    return max(KERNEL_ATOL, 2 * own), own


def graph_depth(fn, target_ms=50.0):
    """(fn, calls a graph, replays) for ``device_ms`` at a grid shape: 100
    calls and 11 replays, as every cluster shape takes them, unless a call
    (events around one, the host's issue included) takes so long that fewer
    calls make ``target_ms``; for a single call, 3 replays."""
    import torch

    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    n = max(1, min(100, int(target_ms / start.elapsed_time(end))))
    return fn, n, (11 if n > 1 else 3)


def check_lstm_shape(device, seed, B, T, D, H, kind):
    """The kernel that ``kind`` names against its plain version at one
    shape, timed on the card, its plan logged; returns the shape's
    numbers."""
    import torch

    from dotaclient_tpu_torch.ops import lstm

    plan = lstm.kernel_plan(B, T, D, H, lstm.device_sms(device))
    if plan.kind != kind:
        raise AssertionError(f"lstm_seq B={B} T={T} D={D} H={H}: the {plan.kind} plan, expected the {kind} plan")
    args = lstm_inputs(B, T, D, H, seed + B + T, device)
    got = lstm.lstm_sequence_kernel(*args)
    torch.cuda.synchronize()
    want = lstm.lstm_sequence_reference(*args)
    err = max_err(got, want)
    atol, plain_err_f64 = (KERNEL_ATOL, None) if D + H <= 256 else wide_atol(args, want)
    if not err <= atol:
        raise AssertionError(f"lstm_seq B={B} T={T} D={D} H={H}: max abs err {err} > {atol}")
    bound, bound_by = lstm_bound(B, T, D, H)
    depth = graph_depth if kind == "grid" else (lambda fn: (fn,))
    plain = lambda: lstm.lstm_sequence_reference(*args)  # noqa: E731
    # past T=1,000 the plain version is tens of thousands of small launches:
    # a graph of it takes longer to build than to run, so one call between
    # events, the host's issue included
    shape = {"B": B, "T": T, "D": D, "H": H, "plan": dataclasses.asdict(plan), "max_abs_err": err, "atol": atol,
             "plain_max_abs_err_vs_f64": plain_err_f64,
             "ms": device_ms(*depth(lambda: lstm.lstm_sequence_kernel(*args))),
             "plain_ms": time_ms(plain, n=1, warmup=1) if T >= 1000 else device_ms(*depth(plain)),
             "plain_timed": "one call, host issue included" if T >= 1000 else "device, in a CUDA graph",
             "bound_ms": bound, "bound_by": bound_by}
    if T == 1:
        library = lstm_cell_library(args)
        lib_h, lib_c = library()
        lib_err = max(float((lib_h - want[1][0]).abs().max()), float((lib_c - want[1][1]).abs().max()))
        log(f"torch.lstm_cell vs plain version: max abs err {lib_err:.3g}")
        shape["library_ms"] = device_ms(library)
        shape["call_ms"] = time_ms(lambda: lstm.lstm_sequence_kernel(*args))
    if 1 < T < 1000 and (D == H == 128 and kind == "cluster" or kind == "grid"):
        reset_free, rf_err = lstm_reset_free_library(args)
        log(f"torch.lstm (cuDNN, reset-free copy) vs plain version on the same copy: max abs err {rf_err:.3g}")
        shape["library_ms_reset_free"] = device_ms(*depth(reset_free))
    where = (f"plan cluster {plan.cluster}, rows per tile {plan.rows}, {plan.grid} blocks of {plan.threads} threads"
             if kind == "cluster" else
             f"grid plan for {lstm.device_sms(device)} SMs, {plan.parts} parts of the batch, {plan.grid} blocks "
             f"of {plan.threads} threads ({plan.units} units each, {plan.kslices} K-slices, weights "
             f"{'resident' if plan.resident else 'streamed from L2'}), {plan.rows} rows a pass "
             f"({plan.thread_rows} a thread, {-(-B // (plan.parts * plan.rows))} passes a part), chunks of "
             f"{plan.kchunk} through {lstm.GRID_STAGES} stages")
    log(
        f"lstm_seq B={B} T={T} D={D} H={H}: {where}, {plan.smem_bytes} B shared memory each; "
        f"max abs err {err:.3g} (atol {atol:.3g}"
        + (f": the plain version {plain_err_f64:.3g} from f64" if plain_err_f64 is not None else "")
        + f"); kernel {shape['ms'] * 1e3:.2f} us on the card, "
        f"plain {shape['plain_ms'] * 1e3:.2f} us, bound {bound * 1e3:.3f} us by {bound_by}"
        + (f", torch.lstm_cell {shape['library_ms'] * 1e3:.2f} us, "
           f"{shape['call_ms'] * 1e3:.2f} us a call with the host's issue" if "library_ms" in shape else "")
        + (f", torch.lstm reset-free {shape['library_ms_reset_free'] * 1e3:.2f} us"
           if "library_ms_reset_free" in shape else "")
    )
    return shape


def check_grid_invariants(device, seed):
    """The grid kernel's bits at the wide core's shapes, as the serve
    engine's replays and the tests rely on them: two launches at the
    serving step B=64 T=1 give the same bits, row 0 of it equals a B=1
    launch on row 0's inputs (its bits depend on no other row, nor on B),
    and at the training batch B=128 a T=1 launch equals step 0 of a T=17
    launch on the same inputs (the sum order ignores T). Raises on any
    difference; returns what it compared."""
    import torch

    from dotaclient_tpu_torch.ops import lstm

    H = WIDE_HIDDEN
    x, h0, c0, wx, wh, b, r = lstm_inputs(64, 1, H, H, seed + 7, device)
    a = lstm.lstm_sequence_kernel(x, h0, c0, wx, wh, b, r)
    a2 = lstm.lstm_sequence_kernel(x, h0, c0, wx, wh, b, r)
    one = lstm.lstm_sequence_kernel(x[:1].contiguous(), h0[:1].contiguous(), c0[:1].contiguous(), wx, wh, b,
                                    r[:1].contiguous())
    x, h0, c0, wx, wh, b, r = lstm_inputs(TRAIN_ENVS, 17, H, H, seed + 8, device)
    seq = lstm.lstm_sequence_kernel(x, h0, c0, wx, wh, b, r)
    step = lstm.lstm_sequence_kernel(x[:, :1].contiguous(), h0, c0, wx, wh, b, r[:, :1].contiguous())
    torch.cuda.synchronize()
    checks = {
        "two_launches_equal": all(torch.equal(u, v) for u, v in zip((a[0], *a[1]), (a2[0], *a2[1]))),
        "row0_equals_B1": all(torch.equal(u[0], v[0]) for u, v in zip((a[0], *a[1]), (one[0], *one[1]))),
        "T1_equals_step0_of_T17": torch.equal(step[0][:, 0], seq[0][:, 0]) and torch.equal(step[1][0], seq[0][:, 0]),
    }
    log(f"lstm_seq grid kernel at H={H}: two launches at B=64 T=1 bitwise equal {checks['two_launches_equal']}, "
        f"row 0 equal to a B=1 launch {checks['row0_equals_B1']}, a T=1 launch equal to step 0 of a T=17 launch "
        f"at B={TRAIN_ENVS} {checks['T1_equals_step0_of_T17']}")
    if not all(checks.values()):
        raise AssertionError(f"lstm_seq grid kernel: bits differ where they must not: {checks}")
    return checks


def check_lstm_kernel(device, seed):
    """Each kernel against its plain version: the cluster kernel at every
    shape of LSTM_SHAPES, the grid-wide kernel at every shape of
    LSTM_GRID_SHAPES, each timed on the card with its plan logged; returns
    the kernels line's two entries (each at its serving step, with the
    worst error of its shapes) and every shape's numbers."""
    from dotaclient_tpu_torch.ops import lstm

    shapes = {s: check_lstm_shape(device, seed, *s, "cluster") for s in LSTM_SHAPES}
    grid = {s: check_lstm_shape(device, seed, *s, "grid") for s in LSTM_GRID_SHAPES}
    grid_bits = check_grid_invariants(device, seed)
    grid_serve, grid_step, grid_seq = (grid[(B, T, WIDE_HIDDEN, WIDE_HIDDEN)]
                                       for B, T in ((64, 1), (TRAIN_ENVS, 1), (TRAIN_ENVS, 17)))
    grid_entry = {
        "name": "lstm_seq_grid",
        "route": "cuda",
        "source": "dotaclient_tpu_torch/ops/csrc/lstm_seq.cu",
        "replaces": "dotaclient_tpu/ops/pallas/lstm.py:117",
        "launches": 0,
        "max_abs_err": max(s["max_abs_err"] for s in grid.values()),
        "ms": grid_serve["ms"],
        "plain_ms": grid_serve["plain_ms"],
        "bound_ms": grid_serve["bound_ms"],
        "bound_by": grid_serve["bound_by"],
        "library_ms": grid_serve["library_ms"],
        "plan": grid_serve["plan"],
        "train_rollout_step_ms": grid_step["ms"],
        "train_sequence_ms": grid_seq["ms"],
    }
    def at(B, T):
        return shapes[(B, T, 128, 128)]

    serve, sequence = at(64, 1), at(32, 16)
    train_step, train_seq, digest_step = at(128, 1), at(128, 17), at(1, 1)
    league_step, league_seq = at(LEAGUE_LANES, 1), at(LEAGUE_LANES, 17)
    league_eval_step = at(LEAGUE_EVAL_LANES, 1)
    adv_seq, mb_seq, mb_seq_instep = at(BUFFERED_BATCH, 17), at(BUFFERED_MB, 16), at(BUFFERED_MB, 17)
    scalar_step = at(SCALAR_LANES, 1)
    selfplay_step, selfplay_seq = at(SELFPLAY_LANES, 1), at(SELFPLAY_LANES, 17)
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
        "buffered_advantage_sequence_ms": adv_seq["ms"],
        "buffered_minibatch_sequence_ms": mb_seq["ms"],
        "buffered_minibatch_instep_sequence_ms": mb_seq_instep["ms"],
        "scalar_pool_step_ms": scalar_step["ms"],
        "selfplay_rollout_step_ms": selfplay_step["ms"],
        "selfplay_fused_sequence_ms": selfplay_seq["ms"],
    }
    extra = {"sequence": sequence, "train_rollout_step": train_step, "train_sequence": train_seq,
             "digest_step": digest_step, "league_rollout_step": league_step, "league_sequence": league_seq,
             "league_eval_step": league_eval_step, "buffered_advantage_sequence": adv_seq,
             "buffered_minibatch_sequence": mb_seq, "buffered_minibatch_instep_sequence": mb_seq_instep,
             "scalar_pool_step": scalar_step, "selfplay_rollout_step": selfplay_step,
             "selfplay_fused_sequence": selfplay_seq, "shapes": list(shapes.values()),
             "grid_shapes": list(grid.values()), "grid_bits": grid_bits,
             "grid_check_launches": lstm.lstm_sequence_kernel.launches_by_plan["grid"]}
    return entry, grid_entry, extra


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


def replayed(engine, requests, replies, releases, n_games, params_by_version, before_step=None):
    """Each dispatch replayed through ``reference_step`` on a carry store of
    our own: yields (its rows, (request_id, version, actions, logp) in row
    order; the replay's packed actions; its log-probs). ``before_step(rows,
    carries)`` runs before each step."""
    import torch

    by_dispatch = {}
    for rid, idx, version, actions, logp, _ in replies:  # arrival = row order
        by_dispatch.setdefault(idx, []).append((rid, version, actions, logp))
    first_dispatch_of_round = {}
    for idx in sorted(by_dispatch):
        first_dispatch_of_round.setdefault(by_dispatch[idx][0][0] // n_games, idx)
    carries = engine.initial_carries()
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
        if before_step is not None:
            before_step(rows, carries)
        reqs = [requests[rid] for rid, _, _, _ in rows]
        packed, logp, carries = engine.reference_step(
            [q[0] for q in reqs], [q[1] for q in reqs], [q[2] for q in reqs], carries, idx,
            params=params_by_version[versions.pop()],
        )
        yield rows, packed, logp


def replay(engine, requests, replies, releases, n_games, params_by_version):
    """Replay every dispatch through ``reference_step`` on a carry store of
    our own; the actions and log-probs must be bitwise those served.
    Returns (the replies that differ, the dispatches replayed)."""
    mismatches = dispatches = 0
    for rows, packed, logp in replayed(engine, requests, replies, releases, n_games, params_by_version):
        dispatches += 1
        for i, (_, _, actions, lp) in enumerate(rows):
            if not (np.array_equal(packed[i], actions) and float(logp[i]) == lp):
                mismatches += 1
    return mismatches, dispatches


def plain_replay(engine, requests, replies, releases, n_games, params_by_version, zeroed=False):
    """Every dispatch replayed as ``replay`` replays it, with the policy's
    LSTM on its plain version (``use_kernel=False``, on the engine's
    device) and each row's served actions in place of the ones it samples
    (the same noise drawn, so the rest of the dispatch is the engine's).
    With ``zeroed`` every carry is zeroed before each dispatch (a control
    that must read farther off). Returns (the largest |served log-prob -
    the plain policy's log-prob of the served action|, the rows whose own
    sample differed from the served actions, the rows)."""
    import torch

    from dotaclient_tpu_torch.models import distributions as D
    from dotaclient_tpu_torch.models import policy as P
    from dotaclient_tpu_torch.ops import lstm

    served, flips = [], [0]
    sample, core = D.sample, P.lstm_sequence

    def plain_core(*args, use_kernel=True):
        return lstm.lstm_sequence(*args, use_kernel=False)

    def served_sample(logits, obs, generator=None):
        acts, _ = sample(logits, obs, generator=generator)
        n = len(served)
        want = torch.as_tensor(np.stack(served).astype(np.int64), device=acts[D.HEADS[0]].device)
        differs = torch.zeros(n, dtype=torch.bool, device=want.device)
        acts = dict(acts)
        for i, h in enumerate(D.HEADS):
            differs |= acts[h][:n] != want[:, i].to(acts[h].dtype)
            acts[h] = torch.cat([want[:, i].to(acts[h].dtype), acts[h][n:]])
        flips[0] += int(differs.sum())
        return acts, D.log_prob(logits, obs, acts)

    def before_step(rows, carries):
        served[:] = [r[2] for r in rows]
        if zeroed:
            for c in carries:
                c.zero_()

    worst, n_rows = 0.0, 0
    D.sample, P.lstm_sequence = served_sample, plain_core
    try:
        for rows, _, logp in replayed(engine, requests, replies, releases, n_games, params_by_version, before_step):
            for i, (_, _, _, lp) in enumerate(rows):
                worst = max(worst, abs(float(logp[i]) - lp))
                n_rows += 1
    finally:
        D.sample, P.lstm_sequence = sample, core
    return worst, flips[0], n_rows


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


def serve_stream(cfg, params, params2, device, seed, what, reset):
    """Phase 3's traffic on a ``ServeEngine`` of ``cfg`` (after a warm-up on
    an engine of its own): 64 games submit 20 steps each with resets at
    episode starts, 2 slot releases and 1 weight swap partway through,
    ``reset()`` (the launch counts to 0) just before, the counts read by the
    caller. Checked: every request answered, legal and finite, zero dispatch
    errors, the swap landed. Returns (the stopped engine, its telemetry
    snapshot, the requests, the replies, the releases, the wall seconds)."""
    import torch

    from dotaclient_tpu_torch.serve import ServeEngine, make_inference_policy
    from dotaclient_tpu_torch.utils import telemetry

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
    reset()
    t0 = time.perf_counter()
    requests, replies, releases = run_games(
        engine, cfg, rng, params2, N_GAMES, N_STEPS, release_round=RELEASE_AFTER_ROUND
    )
    wall = time.perf_counter() - t0
    engine.stop()
    snap = reg.snapshot()

    n = N_GAMES * N_STEPS
    if len(replies) != n or len({r[0] for r in replies}) != n:
        raise AssertionError(f"{what}: {len(replies)} replies for {n} requests")
    if snap["serve/dispatch_errors_total"] != 0:
        raise AssertionError(f"{what}: serve/dispatch_errors_total = {snap['serve/dispatch_errors_total']}")
    good = rows_legal([requests[r[0]][0] for r in replies], [r[3] for r in replies])
    illegal = [r[0] for r, ok in zip(replies, good) if not ok]
    if illegal:
        raise AssertionError(f"{what}: {len(illegal)} illegal actions, e.g. request {illegal[0]}")
    if not all(np.isfinite(r[4]) for r in replies):
        raise AssertionError(f"{what}: non-finite log-prob in a reply")
    if snap["serve/weight_swaps_total"] != 1 or {r[2] for r in replies} != {0, 1}:
        raise AssertionError(f"{what}: the weight swap did not land")
    return engine, snap, requests, replies, releases, wall


def serve_phase(device, seed):
    from dotaclient_tpu_torch.config import RunConfig
    from dotaclient_tpu_torch.models import convert, random_flax_params
    from dotaclient_tpu_torch.ops import lstm

    cfg = RunConfig()
    params = convert(random_flax_params(cfg, seed, value_head=False))
    params2 = convert(random_flax_params(cfg, seed + 1, value_head=False))
    def reset():  # the total; the counts by plan run on from phase 2 (main checks the grid plan's)
        lstm.lstm_sequence_kernel.launches = 0

    engine, snap, requests, replies, releases, wall = serve_stream(cfg, params, params2, device, seed, "serve", reset)
    launches = lstm.lstm_sequence_kernel.launches
    n = N_GAMES * N_STEPS
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


def profile_serve(device, seed, rounds: int = 3):
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


def lifted(fn, on_lift=None):
    """``fn`` with the sync guard lifted around each call; ``on_lift`` runs
    as it is lifted."""
    import torch

    def call(*args, **kwargs):
        mode = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode(0)
        if on_lift is not None:
            on_lift()
        try:
            return fn(*args, **kwargs)
        finally:
            torch.cuda.set_sync_debug_mode(mode)
    return call


def counted(counts, key):
    """An ``on_lift`` that counts the lifts in ``counts[key]``."""
    def bump():
        counts[key] += 1
    return bump


def unguarded_end(learner, on_lift=None):
    """Run the end of each ``train`` call (``_settle`` and ``_seal``: the
    snapshot engine's copies to the host, the final publish, the forced
    save) with the sync guard lifted, so that a guarded ``train`` call holds
    only its loop to the no-host-read rule. ``on_lift`` runs as the guard
    is lifted."""
    learner._settle, learner._seal = lifted(learner._settle, on_lift), lifted(learner._seal, on_lift)


def guarded_train(learner, steps, rec=None):
    """``learner.train(steps)`` with its loop under the sync guard (the end
    of the call runs unguarded: ``unguarded_end``); with ``rec`` the
    engine's copies wait for the guard to lift. Returns (the result, the
    loop's wall seconds: first issue to a synchronise after the last)."""
    import torch

    loop = learner._run_mode_loop
    wall = []

    def timed_loop(num_steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loop(num_steps)
        mode = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode(0)
        try:
            torch.cuda.synchronize()
        finally:
            torch.cuda.set_sync_debug_mode(mode)
        wall.append(time.perf_counter() - t0)

    learner._run_mode_loop = timed_loop
    if rec is not None:
        rec.gate.clear()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = learner.train(steps)
    finally:
        torch.cuda.set_sync_debug_mode(0)
        learner._run_mode_loop = loop
        if rec is not None:
            rec.gate.set()
    return out, sum(wall)


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
    unguarded_end(learner)
    before = {k: v.detach().clone() for k, v in learner.policy.state_dict().items()}
    try:
        torch.cuda.synchronize()
        lstm.lstm_sequence_kernel.launches = 0
        learner.train(TRAIN_WARM * updates)
        torch.cuda.synchronize()
        rec.clear()
        out, wall_s = guarded_train(learner, TRAIN_TIMED * updates)
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
    backend address, re-home count, monotonic time of the reply, the
    reply's carry-shadow row or None) of each step and, per game, the slots
    it held."""
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
                                   time.monotonic(), client.last_carry))
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
    from dotaclient_tpu_torch.utils.tree import tree_map

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
                carry = tree_map(lambda c: torch.roll(c, 1, 0), carry)
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
    mgr = CheckpointManager(ckpt_dir, registry=telemetry.Registry())
    if not mgr.save(learner.state, learner.config, force=True):
        raise AssertionError("checkpoint save failed")
    mgr.close()   # the write has landed
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
    final = no_codec_fallback(json.loads(seen[-1]), "the serve CLI")
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
    for name in ("B", "C"):
        no_codec_fallback(finals[name], f"serve CLI {name}")
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


LEAGUE_WARM, LEAGUE_TIMED, LEAGUE_PROFILED = 2, 8, 1
DEMO_ARGS = ("--steps", "4", "--n-envs", "64", "--team-size", "5", "--opponent", "league",
             "--max-dota-time", "20", "--eval-games", "8")
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
    return finish_child(Child(list(args)), what)


def finish_child(child, what):
    """``run_child`` for a ``Child`` already started (so that work of this
    process can run beside it)."""
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


def demo_launches(summary, what, opponent_lanes):
    """Hold a demo child's ``lstm_seq`` launches (its DEMO_SUMMARY) against
    the count its steps and evaluations derive: a fused iteration T policy
    steps (two a step with ``opponent_lanes``) and an update; an
    evaluation chunk T policy steps, two against the initial self (the
    last of the five). Returns the launches."""
    from dotaclient_tpu_torch.config import default_config

    T = default_config().ppo.rollout_len
    evals = summary["eval_collects"]
    want = (summary["steps"] * (T * (2 if opponent_lanes else 1) + 1) + T * (sum(evals[:4]) + 2 * evals[4]))
    if len(evals) != 5 or summary["lstm_seq_launches"] != want:
        raise AssertionError(f"{what}: {summary['lstm_seq_launches']} lstm_seq launches, expected {want} = "
                             f"{summary['steps']} fused iterations of {T} steps{' x 2' if opponent_lanes else ''} "
                             f"+ 1 and evaluations of {evals} chunks of {T} steps (the last x 2)")
    return want


def league_children(learner, ckpt_dir, meanwhile):
    """The league CLI on a checkpoint of the phase against a second one
    (the step-0 snapshot's params), and the demo at a smoke size, each as a
    child process, side by side and beside ``meanwhile()`` in this process.
    Returns (the children's results, what ``meanwhile`` returned)."""
    import os

    from dotaclient_tpu_torch.utils import telemetry
    from dotaclient_tpu_torch.utils.checkpoint import CheckpointManager, _to_cpu

    a, b = os.path.join(ckpt_dir, "league_a"), os.path.join(ckpt_dir, "league_b")
    mgr_a, mgr_b = (CheckpointManager(d, registry=telemetry.Registry()) for d in (a, b))
    mgr_a.save(learner.state, learner.config, force=True)
    snap0 = learner.league.snapshots[0]
    mgr_b.save_host(
        {"step": 0, "version": 0, "params": {k: v.cpu() for k, v in snap0.params.items()},
         "opt_state": _to_cpu(learner.state.optimizer.state_dict())}, learner.config, force=True)
    for mgr in (mgr_a, mgr_b):
        mgr.close()   # the writes land before the children read them
    children = [Child(["dotaclient_tpu_torch.league", "--checkpoint", a, "--vs", b, "--games",
                       str(LEAGUE_CLI_GAMES)])]
    try:
        children.append(Child(["dotaclient_tpu_torch.train.demo", *DEMO_ARGS]))
        during = meanwhile()
        (lines, cli_s), (demo_lines, demo_s) = (finish_child(c, w) for c, w in
                                                zip(children, ("the league CLI", "the demo")))
    finally:
        for child in children:
            child.kill()
    cli = json.loads(next(line for line in reversed(lines) if line.startswith("{")))
    if not (cli["games"] >= LEAGUE_CLI_GAMES and cli["opponent"] == f"checkpoint:{b}@step0"
            and cli["step"] == learner.state.step and 0.0 <= cli["win_rate"] <= 1.0):
        raise AssertionError(f"the league CLI's line {cli}")
    log(f"league CLI: {json.dumps(cli)} in {cli_s:.1f} s wall")
    summary = json.loads(next(line for line in reversed(demo_lines) if line.startswith("DEMO_SUMMARY "))
                         [len("DEMO_SUMMARY "):])
    rates = [v for k, v in summary.items() if "_win_" in k]
    flag = dict(zip(DEMO_ARGS[::2], DEMO_ARGS[1::2]))
    if not (summary["steps"] == int(flag["--steps"]) and summary["team_size"] == int(flag["--team-size"])
            and len(rates) == 5
            and all(0.0 <= r <= 1.0 for r in rates)):
        raise AssertionError(f"the demo's summary {summary}")
    demo_launches(summary, "the demo", opponent_lanes=flag["--opponent"] == "league")
    log(f"demo {' '.join(DEMO_ARGS)}: DEMO_SUMMARY {json.dumps(summary)} (lstm_seq launches as derived) in "
        f"{demo_s:.1f} s wall")
    return {"cli": {**cli, "wall_s": cli_s}, "demo": {**summary, "wall_s": demo_s}}, during


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
    unguarded_end(learner)
    before = {k: v.detach().clone() for k, v in learner.policy.state_dict().items()}
    try:
        torch.cuda.synchronize()
        lstm.lstm_sequence_kernel.launches = 0
        learner.train(LEAGUE_WARM * updates)
        torch.cuda.synchronize()
        rec.clear()
        out, wall_s = guarded_train(learner, LEAGUE_TIMED * updates)
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
    # the evaluations run in this process while the children run beside them
    result["children"], evals = league_children(learner, ckpt_dir, lambda: {
        "scripted_hard": counted_eval(learner, "scripted_hard", None, seed, device),
        "league": counted_eval(learner, "league", pool.snapshots[0].params, seed, device)})
    result["eval"] = {**evals, "lstm_seq_launches": sum(e["lstm_seq_launches"] for e in evals.values())}
    return result


# -- phase 13: the buffered learner ------------------------------------------------

BUFFERED_ENVS, BUFFERED_MAX_DOTA_TIME = 128, 20.0
# collects: warm, timed under the sync guard, profiled, then one that
# meets the run's first log and checkpoint boundary (BOUNDARY_EVERY steps:
# each collect feeds 128 / 32 batches of 2 x 2 updates)
BUFFERED_WARM, BUFFERED_TIMED, BUFFERED_PROFILED = 1, 4, 1
STEPS_PER_COLLECT = BUFFERED_ENVS // BUFFERED_BATCH * BUFFERED_EPOCHS * BUFFERED_MINIBATCHES
BOUNDARY_EVERY = (BUFFERED_WARM + BUFFERED_TIMED + BUFFERED_PROFILED + 1) * STEPS_PER_COLLECT
# the rollback run: log and checkpoint every 20 steps (a last_good save at
# step 20), the 9th batch (steps 33-36) poisoned, so its verdict reaches the
# engine ahead of the step-40 checkpoint, which is refused. The rollback
# comes at the first boundary after the engine folds it, at step 40 or
# later, and goes back to step 20 wherever it falls. 144 games a collect
# (4.5 batches) leave chunks newer than step 20 in the ring at every
# boundary from step 40 on, so the drop shows wherever the rollback falls.
ROLLBACK_ENVS, ROLLBACK_EVERY, ROLLBACK_POISONED_BATCH, ROLLBACK_STEPS = 144, 20, 9, 80
RESUME_STOP_STEP = 24   # mid collect 2: a held batch and chunks in the ring


def buffered_config(seed, every=10 ** 9, n_envs=BUFFERED_ENVS):
    """The default ``RunConfig`` with phase 6's traffic (128 games against
    the easy bot, 20 s games; ``n_envs`` games if given), 2 epochs of 2
    minibatches over the default batch of 32 chunks, the default ring (256
    chunks, min_fill 32), and log and checkpoint boundaries every ``every``
    optimizer steps."""
    from dotaclient_tpu_torch.config import RunConfig

    cfg = RunConfig()
    return dataclasses.replace(
        cfg,
        env=dataclasses.replace(cfg.env, n_envs=n_envs, opponent="scripted_easy",
                                max_dota_time=BUFFERED_MAX_DOTA_TIME),
        ppo=dataclasses.replace(cfg.ppo, batch_rollouts=BUFFERED_BATCH, epochs_per_batch=BUFFERED_EPOCHS,
                                minibatches=BUFFERED_MINIBATCHES),
        log_every=every,
        checkpoint_every=every,
        seed=seed,
    )


class BufferedRecorder:
    """Records, with no read of the device: CUDA events around each collect
    and each consumed batch's updates, each collect's chunk, each batch's
    metrics; and holds the snapshot engine's copies to the host while a
    guarded loop runs (they start once ``unguarded_end`` lifts the
    guard)."""

    def __init__(self, learner):
        import threading

        import torch

        self.collect_marks, self.batch_marks, self.chunks, self.metrics = [], [], [], []
        self.gate = threading.Event()
        self.gate.set()
        da, engine = learner.device_actor, learner._snap_engine
        collect, optimize, fetch = da.collect, learner._optimize, engine._fetch

        def event():
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            return e

        def timed_collect(params, opp_params=None):
            start = event()
            out = collect(params, opp_params)
            self.collect_marks.append((start, event()))
            self.chunks.append(out[0])
            return out

        def timed_optimize(batch):
            start = event()
            m = optimize(batch)
            self.batch_marks.append((start, event()))
            self.metrics.append(m)
            return m

        def held_fetch(copy):
            if not self.gate.wait(WAIT_S):
                raise AssertionError(f"the snapshot engine's copy was held past {WAIT_S:.0f} s")
            return fetch(copy)

        da.collect, learner._optimize, engine._fetch = timed_collect, timed_optimize, held_fetch
        unguarded_end(learner, on_lift=self.gate.set)

    def clear(self):
        self.collect_marks, self.batch_marks, self.chunks, self.metrics = [], [], [], []


def buffered_rollback(device, seed, ckpt_dir):
    """A poisoned batch after a last_good save: the HEALTH_ROLLBACK line,
    the refused checkpoint, the restore bitwise equal to the slot, the
    poisoned chunks dropped, and the run at its target step."""
    import contextlib
    import io

    import torch

    from dotaclient_tpu_torch.train.learner import Learner
    from dotaclient_tpu_torch.utils import faults, telemetry

    reg = telemetry.Registry()
    faults.configure(f"learner.nan_grad@{ROLLBACK_POISONED_BATCH}")
    try:
        learner = Learner(buffered_config(seed, every=ROLLBACK_EVERY, n_envs=ROLLBACK_ENVS), actor="device", seed=seed, device=device,
                          registry=reg, checkpoint_dir=ckpt_dir)
    finally:
        faults.configure(None)   # the learner keeps the registry it was built with
    restored = []
    restore_last_good = learner.ckpt.restore_last_good

    def checked_restore(*args, **kwargs):
        want, step = learner.ckpt._last_good_slot().restore_weights()
        out = restore_last_good(*args, **kwargs)
        got = {k: v.detach().cpu() for k, v in learner.policy.state_dict().items()}
        restored.append((step, all(torch.equal(got[k], want[k]) for k in want)))
        return out

    learner.ckpt.restore_last_good = checked_restore
    out_text = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out_text):
        out = learner.train(ROLLBACK_STEPS)
    wall_s = time.perf_counter() - t0
    lines = out_text.getvalue().splitlines()
    for line in lines:
        log(f"rollback run: {line[:300]}")
    events = [json.loads(x[len("HEALTH_ROLLBACK "):]) for x in lines if x.startswith("HEALTH_ROLLBACK ")]
    snap = reg.snapshot()
    blocked = snap["health/publish_blocked_total"] + snap["health/checkpoints_blocked_total"]
    if len(events) != 1 or events[0]["to_step"] != ROLLBACK_EVERY:
        raise AssertionError(f"rollback: HEALTH_ROLLBACK lines {events}, expected one back to step {ROLLBACK_EVERY}")
    if restored != [(ROLLBACK_EVERY, True)]:
        raise AssertionError(f"rollback: restores {restored}: the params must equal the last_good slot's bitwise")
    if not (blocked >= 1 and snap["buffer/poison_dropped_total"] > 0 and snap["health/rollbacks_total"] == 1):
        raise AssertionError(f"rollback: blocked {blocked}, poison dropped {snap['buffer/poison_dropped_total']}, "
                             f"rollbacks {snap['health/rollbacks_total']}")
    if not (learner.state.step == ROLLBACK_STEPS and out["optimizer_steps"] == ROLLBACK_STEPS
            and np.isfinite(out["loss"]) and out["health_ok"] == 1.0 and learner._health.unhealthy is None):
        raise AssertionError(f"rollback: step {learner.state.step}, {out['optimizer_steps']} steps, loss {out['loss']}, "
                             f"health_ok {out['health_ok']}, latched {learner._health.unhealthy}")
    learner.close()
    result = {"event": events[0], "restored_step": restored[0][0], "publish_blocked": snap["health/publish_blocked_total"],
              "checkpoints_blocked": snap["health/checkpoints_blocked_total"],
              "poison_dropped": snap["buffer/poison_dropped_total"], "final_step": learner.state.step, "wall_s": wall_s}
    log(f"rollback: batch {ROLLBACK_POISONED_BATCH} poisoned, {json.dumps(events[0])}; params bitwise equal to the "
        f"last_good slot (step {restored[0][0]}); {blocked:.0f} publish or checkpoint blocked, "
        f"{snap['buffer/poison_dropped_total']:.0f} poisoned chunks dropped; the run reached step "
        f"{learner.state.step} healthy in {wall_s:.1f} s")
    return result


def buffered_resume(device, seed, ckpt_dir):
    """``request_stop`` mid-run, then ``Learner(..., restore=True)``: the
    ring, the slot versions, the actor's state and RNG and ``mb_draws``
    equal what was saved, bitwise, and the next permutation is the one an
    uninterrupted run draws."""
    import torch

    from dotaclient_tpu_torch.utils.tree import tree_leaves
    from dotaclient_tpu_torch.train.learner import Learner
    from dotaclient_tpu_torch.utils import telemetry

    cfg = buffered_config(seed)
    make = lambda **kw: Learner(cfg, actor="device", seed=seed, device=device,  # noqa: E731
                                registry=telemetry.Registry(), **kw)
    a = make(checkpoint_dir=ckpt_dir)
    after_step = a._after_step

    def stop_at(m, frames, stride):
        rewound = after_step(m, frames, stride)
        if a.state.step >= RESUME_STOP_STEP:
            a.request_stop()
        return rewound

    a._after_step = stop_at
    out = a.train(10 * RESUME_STOP_STEP)
    saved = {"buffer": a.buffer.state_dict(), "actor": [t.detach().cpu() for t in tree_leaves(a.device_actor.state)],
             "rng": a.device_actor.generator.get_state(), "mb_draws": a._mb_draws,
             "params": {k: v.detach().cpu() for k, v in a.policy.state_dict().items()}}
    if not (out["optimizer_steps"] == RESUME_STOP_STEP and saved["buffer"]["order"].ge(0).sum() > 0):
        raise AssertionError(f"resume: stopped after {out['optimizer_steps']} steps with "
                             f"{int(saved['buffer']['order'].ge(0).sum())} chunks in the ring")
    a.close()
    b = make(checkpoint_dir=ckpt_dir, restore=True)
    got = b.buffer.state_dict()
    bad = [k for k in ("order", "free", "slot_version", "counters") if not torch.equal(got[k], saved["buffer"][k])]

    bad += ["store"] * (not all(torch.equal(x, y) for x, y in zip(tree_leaves(got["store"]),
                                                                   tree_leaves(saved["buffer"]["store"]))))
    bad += ["actor"] * (not all(torch.equal(x.cpu(), y) for x, y in zip(tree_leaves(b.device_actor.state),
                                                                      saved["actor"])))
    bad += ["rng"] * (not torch.equal(b.device_actor.generator.get_state(), saved["rng"]))
    bad += ["mb_draws"] * (b._mb_draws != saved["mb_draws"])
    bad += ["params"] * (not all(torch.equal(v.cpu(), saved["params"][k]) for k, v in b.policy.state_dict().items()))
    c = make()
    c.train(RESUME_STOP_STEP)
    perm_b, perm_c = b._mb_rng.permutation(BUFFERED_BATCH), c._mb_rng.permutation(BUFFERED_BATCH)
    bad += ["permutation"] * (not np.array_equal(perm_b, perm_c) or c._mb_draws != saved["mb_draws"])
    for learner in (b, c):
        learner.close()
    if bad:
        raise AssertionError(f"resume: restored state differs from the saved one in {bad}")
    n_ring = int(saved["buffer"]["order"].ge(0).sum())
    log(f"resume: stopped at step {RESUME_STOP_STEP} with {n_ring} chunks in the ring; the restore's ring, slot "
        f"versions, actor state and RNG, {saved['mb_draws']} minibatch draws and params equal the saved ones "
        f"bitwise; the next permutation equals an uninterrupted run's")
    return {"stop_step": RESUME_STOP_STEP, "ring_chunks": n_ring, "mb_draws": saved["mb_draws"]}


def buffered_phase(device, seed, ckpt_dir, fused_frames_per_s):
    """The buffered learner on the card: warm-up, timed collects under the
    sync guard, a profiled window, one boundary under the guard with the
    engine's copies held; then the rollback, the resume and the CLI."""
    import os

    import torch

    from dotaclient_tpu_torch.ops import lstm
    from dotaclient_tpu_torch.train.learner import Learner
    from dotaclient_tpu_torch.utils import telemetry

    cfg = buffered_config(seed, every=BOUNDARY_EVERY)
    T, B = cfg.ppo.rollout_len, cfg.ppo.batch_rollouts
    updates = cfg.ppo.steps_per_batch
    reg = telemetry.Registry()
    learner = Learner(cfg, actor="device", seed=seed, device=device, registry=reg,
                      checkpoint_dir=os.path.join(ckpt_dir, "buffered"))
    da, buf = learner.device_actor, learner.buffer
    per_collect = STEPS_PER_COLLECT
    if not (learner.epoch_step is not None and learner.advantage_pass is not None
            and da.n_lanes // B * updates == per_collect and da.n_lanes % B == 0):
        raise AssertionError("phase 13 must run the epoch step and the one-pass advantage pass on whole batches")
    rec = BufferedRecorder(learner)
    before = {k: v.detach().clone() for k, v in learner.policy.state_dict().items()}
    torch.cuda.synchronize()
    lstm.lstm_sequence_kernel.launches = 0
    guarded_train(learner, BUFFERED_WARM * per_collect)
    rec.clear()
    out, loop_s = guarded_train(learner, BUFFERED_TIMED * per_collect)
    collect_ms = statistics.mean(a.elapsed_time(b) for a, b in rec.collect_marks)
    batch_ms = statistics.mean(a.elapsed_time(b) for a, b in rec.batch_marks)
    timed = {"collects": len(rec.collect_marks), "batches": len(rec.batch_marks)}
    metrics = [{k: float(v) for k, v in m.items()} for m in rec.metrics]
    chunks = list(rec.chunks)
    rec.clear()
    profile = profiled(lambda: learner.train(BUFFERED_PROFILED * per_collect))
    prof_counts = {"collects": len(rec.collect_marks), "batches": len(rec.batch_marks)}
    chunks += rec.chunks
    metrics += [{k: float(v) for k, v in m.items()} for m in rec.metrics]
    rec.clear()
    boundary_out, _ = guarded_train(learner, per_collect, rec)
    torch.cuda.synchronize()
    chunks += rec.chunks
    metrics += [{k: float(v) for k, v in m.items()} for m in rec.metrics]
    launches = lstm.lstm_sequence_kernel.launches
    snap = reg.snapshot()
    collects = BUFFERED_WARM + BUFFERED_TIMED + BUFFERED_PROFILED + 1
    batches = collects * da.n_lanes // B
    passes = snap["advantage/passes_total"]
    expected = collects * T + passes + batches * updates
    if launches != expected:
        raise AssertionError(f"lstm_seq launched {launches} times: expected {collects} collects x {T} + {passes:.0f} "
                             f"advantage passes + {batches} batches x {updates} updates = {expected:.0f}")
    if passes != batches:
        raise AssertionError(f"advantage/passes_total {passes} != {batches} batches consumed")
    dropped = {"stale": buf.dropped_stale, "overflow": buf.dropped_overflow}
    if not buf.ingested == collects * da.n_lanes == batches * B + buf.size + sum(dropped.values()):
        raise AssertionError(f"ring books: ingested {buf.ingested}, {collects} collects x {da.n_lanes}, "
                             f"{batches} batches x {B} + size {buf.size} + dropped {dropped}")
    for i, m in enumerate(metrics):
        if not (np.isfinite(m["loss"]) and np.isfinite(m["grad_norm"]) and m["health_ok"] == 1.0):
            raise AssertionError(f"batch {i}: loss {m['loss']}, grad_norm {m['grad_norm']}, health_ok {m['health_ok']}")
    if len(metrics) != batches - BUFFERED_WARM * da.n_lanes // B:
        raise AssertionError(f"{len(metrics)} batches recorded after the warm-up")
    moved, cast_legal, ability_choice = check_params_moved(before, learner.policy, chunks)
    illegal, n_actions = check_chunk_actions(chunks)
    if illegal:
        raise AssertionError(f"{illegal} of {n_actions} sampled actions illegal under their masks")
    if not (len(learner.history) == 1 and learner.history[0]["step"] == BOUNDARY_EVERY
            and learner.ckpt.last_good_step() == BOUNDARY_EVERY and snap["snapshot/errors_total"] == 0):
        raise AssertionError(f"the boundary at step {BOUNDARY_EVERY}: log lines {[h['step'] for h in learner.history]}, "
                             f"last_good {learner.ckpt.last_good_step()}, engine errors {snap['snapshot/errors_total']}")
    stats = da.stats()
    if not stats["episodes_done"] > 0:
        raise AssertionError("no episode ended in the buffered phase")
    frames = timed["batches"] * B * T
    learner.close()
    result = {
        "n_envs": cfg.env.n_envs, "lanes": da.n_lanes, "rollout_len": T, "batch_rollouts": B,
        "epochs_per_batch": cfg.ppo.epochs_per_batch, "minibatches": cfg.ppo.minibatches,
        "capacity_rollouts": cfg.buffer.capacity_rollouts, "min_fill": cfg.buffer.min_fill,
        "collects": collects, "batches": batches, "timed": timed, "profiled": prof_counts,
        "frames_trained": frames, "frames_per_s": frames / loop_s,
        "loop_ms": loop_s * 1e3,
        "collect_ms": collect_ms, "batch_ms": batch_ms,
        "wall_ms_per_collect": loop_s * 1e3 / timed["collects"],
        "wall_ms_per_batch": loop_s * 1e3 / timed["batches"],
        "fused_frames_per_s": fused_frames_per_s,
        "snapshot_d2h_ms": snap["snapshot/d2h_ms"], "stall_fraction": snap["learner/stall_fraction"],
        "lstm_seq_launches": launches, "advantage_passes": passes,
        "ring": {"ingested": buf.ingested, "size": buf.size, **dropped},
        "actions_checked": n_actions, "params_moved": sum(moved.values()), "params": len(moved),
        "frames_that_could_cast": cast_legal, "frames_with_a_choice_of_ability": ability_choice,
        "episodes_done": stats["episodes_done"], "last_metrics": metrics[-1], "timed_out": {
            k: out[k] for k in ("optimizer_steps", "frames_trained")},
        "boundary_log_line": learner.history[0]["step"], "sync_debug_mode": "error",
        "profile": {"collects": BUFFERED_PROFILED, **profile},
    }
    log(
        f"buffered: {timed['collects']} timed collects x {da.n_lanes} lanes x {T} steps into the ring, "
        f"{timed['batches']} batches of {B} x {updates} updates (E={cfg.ppo.epochs_per_batch} M={cfg.ppo.minibatches}) "
        f"= {frames} trained frames in {loop_s * 1e3:.1f} ms of loop: {result['frames_per_s']:.0f} frames/s "
        f"(phase 6's fused {fused_frames_per_s:.0f}), {result['wall_ms_per_collect']:.2f} ms wall a collect, "
        f"{result['wall_ms_per_batch']:.2f} ms a batch; between CUDA events a collect {collect_ms:.2f} ms, a batch's "
        f"updates {batch_ms:.2f} ms; no host sync inside the loops, the boundary at step {BOUNDARY_EVERY} included "
        f"(its copies to the host held until the guard lifted); snapshot/d2h_ms {snap['snapshot/d2h_ms']:.3f}, "
        f"learner/stall_fraction {snap['learner/stall_fraction']:.4f}; loss {metrics[-1]['loss']:.4g}, health_ok 1 in "
        f"all; {n_actions} actions legal; {sum(moved.values())} of {len(moved)} param tensors moved; "
        f"{stats['episodes_done']:.0f} episodes; ring ingested {buf.ingested} = {batches} x {B} + {buf.size} + "
        f"dropped {dropped}; advantage passes {passes:.0f}; lstm_seq launches {launches} = {collects} x {T} + "
        f"{passes:.0f} + {batches} x {updates}"
    )
    log_profile(f"buffered profile: {BUFFERED_PROFILED} collects", profile)
    # the CLI child runs beside the rollback and the resume
    cli_jsonl = os.path.join(ckpt_dir, "cli.jsonl")
    child = Child(["dotaclient_tpu_torch.train.learner", "--smoke", "--steps", "3", "--metrics-jsonl", cli_jsonl])
    try:
        result["rollback"] = buffered_rollback(device, seed, os.path.join(ckpt_dir, "rollback"))
        result["resume"] = buffered_resume(device, seed, os.path.join(ckpt_dir, "resume"))
        lines, cli_s = finish_child(child, "the learner CLI")
    finally:
        child.kill()
    steps, frames, _, _ = done_line(lines, "the learner CLI")
    cli = read_record(cli_jsonl)[1][-1]
    if not (steps == 3 and cli["optimizer_steps"] == 3.0 and np.isfinite(cli["loss"]) and cli["health_ok"] == 1.0):
        raise AssertionError(f"the learner CLI: {steps} steps, its record's last line {cli}")
    log(f"learner CLI --smoke --steps 3 (default actor): {steps} steps, {frames} frames, loss {cli['loss']:.4g} "
        f"in {cli_s:.1f} s wall")
    result["cli"] = {"optimizer_steps": steps, "frames_trained": frames, "wall_s": cli_s}
    return result


# -- phase 14: the run record and the rest of the checkpoint -----------------------

# (a)'s child: phase 13's traffic on the default config (batches of 32,
# one update each on the in-step estimator, B=32 T=17: at E x M = 1 no
# advantage pass runs), a periodic save every 8 steps, and one log line
# (the default log_every of 10) before the closing one
RECORD_ENVS, RECORD_STEPS, RECORD_EVERY = 128, 16, 8
# (b): the 11th update raises (the step-10 log line and the step-8 save
# behind it), so the crash save lands at step 10; the resume trains 4 more
CRASH_AT, CRASH_STEP, RESUME_STEPS = 11, 10, 4
# (d): phase 13's config, a log boundary a collect, 8 collects (the 20 s
# games end in the 7th), checkpoint_best_min_episodes cut from 50
BEST_COLLECTS, BEST_MIN_EPISODES = 8, 16
SAVE_REPS = 3
RECORD_CHILD_S = 300.0


class ModuleChild:
    """``python -m MODULE ARGS`` as a child process, its stdout and stderr
    into files (so children can run side by side without a pipe filling
    up); ``lines`` reads its stdout so far, ``wait`` waits for its exit
    within a bound, ``kill`` leaves nothing running. The child leads a
    process group of its own, and ``kill`` takes the group: the processes
    a launcher or a supervisor child starts go with it."""

    def __init__(self, module, args, root, name, env=None):
        import os
        import pathlib

        repo = str(pathlib.Path(__file__).resolve().parent)
        env = {**os.environ, "PYTHONPATH": repo + os.pathsep + os.environ.get("PYTHONPATH", ""),
               "PYTHONUNBUFFERED": "1", **(env or {})}
        self.name, self.t0 = name, time.perf_counter()
        self._out, self._err = (open(os.path.join(root, f"{name}.{k}"), "w+") for k in ("out", "err"))
        self.proc = subprocess.Popen([sys.executable, "-m", module, *args], cwd=repo, env=env, stdout=self._out,
                                     stderr=self._err, text=True, start_new_session=True)
        self.wall_s = None

    def lines(self):
        with open(self._out.name) as f:
            return f.read().splitlines()

    def stderr(self):
        with open(self._err.name) as f:
            return f.read()

    def wait(self, timeout):
        try:
            rc = self.proc.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            raise AssertionError(f"{self.name} ran past {timeout:.0f} s") from None
        self.wall_s = time.perf_counter() - self.t0
        return rc

    def kill(self):
        import os
        import signal

        try:
            os.killpg(self.proc.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
        if self.proc.poll() is None:
            self.proc.kill()
        self.proc.wait(timeout=30)
        self._out.close()
        self._err.close()


class RecordChild(ModuleChild):
    """``python -m dotaclient_tpu_torch.train.learner ARGS`` as a child.
    ``result`` waits for its exit within RECORD_CHILD_S: (exit code, stdout
    lines, stderr, wall seconds)."""

    def __init__(self, args, root, name, env=None):
        super().__init__("dotaclient_tpu_torch.train.learner", args, root, name, env)

    def result(self):
        rc = self.wait(RECORD_CHILD_S)
        return rc, self.lines(), self.stderr(), self.wall_s


def done_fields(lines, what):
    """The learner CLI's closing ``done: N steps, F frames, R frames/sec, D
    native decodes, E native encodes, P proto fallbacks, L lstm_seq
    launches`` line as a dict; a run whose rollout codec fell back to
    protobuf fails."""
    import re

    keys = ("steps", "frames", "frames_per_s", "native_decodes", "native_encodes", "proto_fallbacks", "launches")
    for line in reversed(lines):
        m = re.fullmatch(r"done: (\d+) steps, (\d+) frames, (\d+) frames/sec, (\d+) native decodes, (\d+) native "
                         r"encodes, (\d+) proto fallbacks, (\d+) lstm_seq launches", line)
        if m:
            out = dict(zip(keys, (int(g) for g in m.groups())))
            if out["proto_fallbacks"]:
                raise AssertionError(f"{what}'s rollout codec fell back to protobuf: {line}")
            return out
    raise AssertionError(f"{what} printed no done: line: {lines[-5:]}")


def done_line(lines, what):
    """The ``done:`` line's (N steps, F frames, R frames/sec, L lstm_seq
    launches)."""
    d = done_fields(lines, what)
    return d["steps"], d["frames"], d["frames_per_s"], d["launches"]


def no_codec_fallback(last_line, what):
    """A serve CLI's last line: its rollout codec ran native, no call fell
    back to protobuf."""
    if last_line.get("proto_fallbacks", 1) != 0:
        raise AssertionError(f"{what}'s rollout codec fell back to protobuf (or did not say): {last_line}")
    return last_line


def read_record(path):
    """A --metrics-jsonl file: (its lines, the scalars of each metrics
    line)."""
    from dotaclient_tpu_torch.utils import telemetry

    lines = telemetry.load_jsonl(path)
    return lines, [json.loads(x)["scalars"] for x in lines if '"scalars"' in x]


def profile_kernel_launches(profile_dir, kernel="lstm_seq"):
    """The Chrome trace ``--profile`` wrote: (its bytes, the kernel events
    whose name holds ``kernel``)."""
    import glob
    import os

    paths = glob.glob(os.path.join(profile_dir, "*.json"))
    if len(paths) != 1:
        raise AssertionError(f"--profile {profile_dir} holds {paths}, expected one trace")
    with open(paths[0]) as f:
        events = json.load(f)["traceEvents"]
    n = sum(1 for e in events if e.get("cat") == "kernel" and kernel in e.get("name", ""))
    return os.path.getsize(paths[0]), n


def record_child_phase(device, seed, root):
    """(a) the learner CLI with every sink of the run record and the
    profiler, beside (b) a crash through --on-crash-checkpoint, then its
    resume: the children run side by side (they share the card, each its
    own directories) to keep the phase short."""
    import os

    d, jsonl, logdir, prof, d2 = (os.path.join(root, n) for n in ("ckpt", "run.jsonl", "tb", "profile", "crash"))
    common = ["--n-envs", str(RECORD_ENVS), "--opponent", "scripted_easy", "--seed", str(seed)]
    children = []
    try:
        children.append(RecordChild(
            [*common, "--steps", str(RECORD_STEPS), "--checkpoint-dir", d, "--checkpoint-every", str(RECORD_EVERY),
             "--metrics-jsonl", jsonl, "--logdir", logdir, "--profile", prof], root, "recorded"))
        children.append(RecordChild(
            [*common, "--steps", str(RECORD_STEPS), "--checkpoint-dir", d2, "--checkpoint-every", str(RECORD_EVERY),
             "--on-crash-checkpoint"], root, "crashing", env={"DOTA_FAULTS": f"learner.fail_train_step@{CRASH_AT}"}))
        crash = check_crash(d2, children[1].result())
        children.append(RecordChild([*common, "--steps", str(RESUME_STEPS), "--checkpoint-dir", d2, "--restore"],
                                    root, "resumed"))
        result = check_recorded(device, d, jsonl, logdir, prof, children[0].result())
        result["crash"] = {**crash, **check_resume(d2, children[2].result())}
    finally:
        for child in children:
            child.kill()
    return result


def check_recorded(device, d, jsonl, logdir, prof, ran):
    """(a): the record against the tiers, the memory gauge, the --logdir
    sink, the trace's lstm_seq kernels, the checkpoints."""
    import os

    import torch

    from dotaclient_tpu_torch.utils import schema, telemetry
    from dotaclient_tpu_torch.utils.checkpoint import CheckpointManager

    rc, lines, err, wall_s = ran
    if rc != 0:
        raise AssertionError(f"the recorded learner CLI exited {rc}: {lines[-10:]}\n{err[-3000:]}")
    steps, frames, _, launched = done_line(lines, "the recorded learner CLI")
    raw, rows = read_record(jsonl)
    errors = schema.validate_lines(raw, schema.LEARNER_TIERS)
    if errors or steps != RECORD_STEPS or [len(raw), len(rows)] != [2, 2]:
        raise AssertionError(f"the record: {errors}, {steps} steps, {len(raw)} lines")
    last = rows[-1]
    card_bytes = torch.cuda.get_device_properties(device).total_memory
    if not 0 < last["mem/hbm_peak_bytes"] < card_bytes:
        raise AssertionError(f"mem/hbm_peak_bytes {last['mem/hbm_peak_bytes']} outside (0, {card_bytes})")
    try:
        import tensorboardX  # noqa: F401
        tb = bool(os.path.isdir(logdir) and os.listdir(logdir))
        tb_what = "tensorboardX event files written"
    except ImportError:
        warned = [x for x in lines if x.startswith("WARNING: tensorboardX not installed")]
        tb, tb_what = len(warned) == 1, "tensorboardX absent: --logdir degraded with one warning"
    if not tb:
        raise AssertionError(f"--logdir: {tb_what} expected; stdout {lines[:5]}")
    trace_bytes, traced = profile_kernel_launches(prof)
    collects = RECORD_STEPS * 32 // RECORD_ENVS
    expected = collects * 16 + RECORD_STEPS   # the rollout steps, and one update a batch
    if not traced == launched == expected:
        raise AssertionError(f"the child's trace holds {traced} lstm_seq kernels and its done: line counts "
                             f"{launched}, expected {expected}")
    reg = telemetry.Registry()
    mgr = CheckpointManager(d, registry=reg)
    step16, ok = mgr.restore_weights()[1], os.path.isfile(os.path.join(d, str(RECORD_STEPS), "pipeline.pt"))
    if not (mgr.all_steps() == [RECORD_EVERY, RECORD_STEPS] and step16 == RECORD_STEPS and ok
            and mgr.last_good_step() == RECORD_STEPS and reg.snapshot()["checkpoint/manifest_failures_total"] == 0):
        raise AssertionError(f"the child's checkpoints: steps {mgr.all_steps()}, pipeline {ok}, last_good "
                             f"{mgr.last_good_step()}")
    util = {k[len("util/phase/"):]: round(v, 4) for k, v in rows[0].items() if k.startswith("util/phase/")}
    result = {
        "wall_s": wall_s, "steps": steps, "frames": frames, "record_lines": len(raw),
        "record_bytes": os.path.getsize(jsonl), "keys": len(last), "tensorboard": tb_what,
        "hbm_peak_bytes": last["mem/hbm_peak_bytes"], "trace_bytes": trace_bytes, "traced_lstm_seq": traced,
        "util_phases": util, "duty_cycle": rows[0]["util/duty_cycle"],
        "prefetch_hit_rate": last["learner/prefetch_hit_rate"], "overlap_fraction": last["learner/overlap_fraction"],
        "advantage_overlap_fraction": last["advantage/overlap_fraction"],
        "metrics_fetch_ms": 1e3 * last["span/learner/metrics_fetch/mean_s"],
        "checkpoints": mgr.all_steps(),
    }
    log(f"run record (a): the learner CLI at {RECORD_ENVS} games, {steps} steps in {wall_s:.1f} s wall; "
        f"{len(raw)} lines, {len(last)} keys, {result['record_bytes']} bytes, every tier present; "
        f"mem/hbm_peak_bytes {last['mem/hbm_peak_bytes']:.0f}; {tb_what}; its profile {trace_bytes} bytes with "
        f"{traced} lstm_seq kernels ({collects} collects x 16 + {RECORD_STEPS} updates); "
        f"checkpoints {mgr.all_steps()} with the pipeline at {RECORD_STEPS}; at step 10 util/duty_cycle "
        f"{rows[0]['util/duty_cycle']:.4f}, phases {util}; prefetch hit rate "
        f"{last['learner/prefetch_hit_rate']:.3f}, overlap {last['learner/overlap_fraction']:.3f}, advantage "
        f"overlap {last['advantage/overlap_fraction']:.3f}, metrics fetch {result['metrics_fetch_ms']:.2f} ms")
    return result


def check_crash(d2, ran):
    """(b): a non-zero exit with the injected error, the rescue's line, the
    crash step verified by its manifest."""
    from dotaclient_tpu_torch.utils import telemetry
    from dotaclient_tpu_torch.utils.checkpoint import CheckpointManager

    rc, lines, err, crash_s = ran
    saved = [x for x in lines if x.startswith(f"learner: crash checkpoint saved to {d2}")]
    if rc == 0 or "injected fault: learner.fail_train_step" not in err or len(saved) != 1:
        raise AssertionError(f"the crash: exit {rc}, stderr {err[-1500:]}, stdout {lines[-5:]}")
    reg = telemetry.Registry()
    mgr = CheckpointManager(d2, registry=reg)
    if not (mgr.latest_step() == CRASH_STEP and mgr.restore_weights()[1] == CRASH_STEP
            and reg.snapshot()["checkpoint/manifest_failures_total"] == 0):
        raise AssertionError(f"the crash save: steps {mgr.all_steps()}")
    log(f"run record (b): learner.fail_train_step@{CRASH_AT} with --on-crash-checkpoint: exit {rc}, the injected "
        f"error on stderr, '{saved[0]}', step {CRASH_STEP} verified by its manifest ({crash_s:.1f} s wall)")
    return {"exit": rc, "crash_step": CRASH_STEP, "wall_s": crash_s}


def check_resume(d2, ran):
    """(b): the --restore child resumes from the crash save and exits 0."""
    from dotaclient_tpu_torch.utils import telemetry
    from dotaclient_tpu_torch.utils.checkpoint import CheckpointManager

    rc, lines, err, resume_s = ran
    if rc != 0 or done_line(lines, "the resumed learner CLI")[0] != RESUME_STEPS:
        raise AssertionError(f"the resume exited {rc}: {lines[-5:]}\n{err[-2000:]}")
    mgr = CheckpointManager(d2, registry=telemetry.Registry())
    if mgr.latest_step() != CRASH_STEP + RESUME_STEPS:
        raise AssertionError(f"the resume's steps {mgr.all_steps()}")
    log(f"run record (b): --restore trained from step {CRASH_STEP} to {mgr.latest_step()} and exited 0 "
        f"({resume_s:.1f} s wall)")
    return {"resume_wall_s": resume_s, "resumed_to": mgr.latest_step()}


def timed_saves(mgr, save):
    """``save()`` then ``mgr.wait()``, SAVE_REPS times: the medians of the
    save's return and of the wait, in ms."""
    back, landed = [], []
    for _ in range(SAVE_REPS):
        t0 = time.perf_counter()
        save()
        t1 = time.perf_counter()
        mgr.wait()
        back.append((t1 - t0) * 1e3)
        landed.append((time.perf_counter() - t1) * 1e3)
    return {"save_ms": statistics.median(back), "wait_ms": statistics.median(landed)}


def record_inprocess_phase(device, seed, root, smi):
    """(c) the save timing and (d) best-model rotation, on phase 13's
    buffered learner in this process."""
    import os

    import torch

    from dotaclient_tpu_torch.ops import lstm
    from dotaclient_tpu_torch.train.learner import Learner
    from dotaclient_tpu_torch.utils import telemetry
    from dotaclient_tpu_torch.utils.checkpoint import CheckpointManager

    cfg = dataclasses.replace(buffered_config(seed, every=STEPS_PER_COLLECT),
                              checkpoint_best_min_episodes=BEST_MIN_EPISODES)
    d, jsonl = os.path.join(root, "best_run"), os.path.join(root, "best_run.jsonl")
    reg = telemetry.Registry()
    learner = Learner(cfg, actor="device", seed=seed, device=device, registry=reg, checkpoint_dir=d,
                      metrics_jsonl=jsonl)
    saved_best, tail = [], {}
    maybe_save_best, save, wait = learner._maybe_save_best, learner.ckpt.save, learner.ckpt.wait

    def recording_best(scalars):
        before = learner._best_win
        maybe_save_best(scalars)
        if learner._best_win != before:
            saved_best.append((learner._best_win, learner.state.step,
                               {k: v.detach().cpu().clone() for k, v in learner.policy.state_dict().items()}))

    def timed(name, fn):
        def call(*args, **kwargs):
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            tail[name] = (time.perf_counter() - t0) * 1e3
            return out
        return call

    learner._maybe_save_best = recording_best
    learner.ckpt.save, learner.ckpt.wait = timed("save_ms", save), timed("wait_ms", wait)
    torch.cuda.synchronize()
    lstm.lstm_sequence_kernel.launches = 0
    out = learner.train(BEST_COLLECTS * STEPS_PER_COLLECT)
    torch.cuda.synchronize()
    launches = lstm.lstm_sequence_kernel.launches
    learner.ckpt.save, learner.ckpt.wait = save, wait
    T, B = cfg.ppo.rollout_len, cfg.ppo.batch_rollouts
    batches = BEST_COLLECTS * learner.device_actor.n_lanes // B
    passes = reg.snapshot()["advantage/passes_total"]
    expected = BEST_COLLECTS * T + passes + batches * cfg.ppo.steps_per_batch
    if launches != expected or passes != batches:
        raise AssertionError(f"lstm_seq launched {launches} times in (d), expected {expected}")
    # (c): the state alone and with the pipeline (the ring at 256 chunks),
    # into a directory of their own
    timing_mgr = CheckpointManager(os.path.join(root, "timing"), registry=telemetry.Registry())
    pipeline = learner._pipeline_state()
    state_only = timed_saves(timing_mgr, lambda: timing_mgr.save(learner.state, cfg, force=True))
    with_pipeline = timed_saves(timing_mgr, lambda: timing_mgr.save(learner.state, cfg, force=True,
                                                                    pipeline=pipeline))
    timing_mgr.close()
    # the end-of-train save again, synchronous: the same forced save of the
    # same state and pipeline into the learner's directory, its write run
    # on this thread instead of being handed to the writer
    mark_good = learner._health is not None and learner._health.unhealthy is None
    learner.ckpt._hand_off = lambda job: job()
    sync = timed_saves(learner.ckpt, lambda: learner.ckpt.save(learner.state, cfg, force=True, pipeline=pipeline,
                                                               mark_good=mark_good))
    del learner.ckpt._hand_off
    ring_bytes = reg.snapshot()["buffer/shard_bytes"]
    timing = {"card": smi, "state": state_only, "state_and_pipeline": with_pipeline, "ring_bytes": ring_bytes,
              "end_of_train": {"save_ms": tail["save_ms"], "wait_ms": tail["wait_ms"], "sync_ms": sync["save_ms"]}}
    log(f"run record (c) on {smi}: CheckpointManager.save returns / wait lands, median of {SAVE_REPS}: the train "
        f"state {state_only['save_ms']:.2f} / {state_only['wait_ms']:.2f} ms; with the pipeline (the ring of "
        f"{cfg.buffer.capacity_rollouts} chunks, {ring_bytes:.0f} bytes) {with_pipeline['save_ms']:.2f} / "
        f"{with_pipeline['wait_ms']:.2f} ms; the forced end-of-train save on the train thread, async: "
        f"{tail['save_ms']:.2f} ms to return, {tail['wait_ms']:.2f} ms more to land; sync (the same save written "
        f"on the train thread, median of {SAVE_REPS}): {sync['save_ms']:.2f} ms")
    # (d): best/ holds the highest qualifying logged window, saved at the
    # step the train thread applied it
    logged = [h for h in learner.history if h["episodes_recent"] >= BEST_MIN_EPISODES]
    best_dir = os.path.join(d, "best")
    if not (logged and saved_best and os.path.isdir(best_dir)):
        raise AssertionError(f"no best save: qualifying windows {len(logged)}, saves {len(saved_best)}")
    with open(os.path.join(best_dir, "best_meta.json")) as f:
        meta = json.load(f)
    win, step, params = saved_best[-1]
    first_max = next(h for h in logged if h["win_rate_recent"] == max(x["win_rate_recent"] for x in logged))
    if not (meta == {"win_rate_recent": win, "step": step} and win == first_max["win_rate_recent"]
            and first_max["step"] <= step <= learner.state.step and learner.ckpt_best.latest_step() == step):
        raise AssertionError(f"best_meta {meta}: the saves {[s[:2] for s in saved_best]}, qualifying windows "
                             f"{[(h['step'], h['win_rate_recent']) for h in logged]}")
    # the rotation rule past the run's single qualifying window: a higher
    # window moves best/, then a lower one, an equal one and a higher one
    # over too few episodes leave it
    if win >= 1.0:
        raise AssertionError(f"the run's best window is already {win}: no higher one to feed")
    higher, lower = (1.0 + win) / 2, (1.0 + 3 * win) / 4
    fed = [(higher, BEST_MIN_EPISODES), (lower, BEST_MIN_EPISODES), (higher, BEST_MIN_EPISODES),
           (1.0, BEST_MIN_EPISODES - 1)]
    n_saves, last, written = len(saved_best), int(learner.state.step), set()
    for wr, eps in fed:
        learner._maybe_save_best({"win_rate_recent": wr, "episodes_recent": float(eps)})
        learner.ckpt_best.wait()
        meta_path = os.path.join(best_dir, "best_meta.json")
        with open(meta_path) as f:
            fed_meta = json.load(f)
        # the meta file is replaced on every save: one file means one save
        written.add((os.stat(meta_path).st_ino, os.stat(meta_path).st_mtime_ns))
        if (fed_meta != {"win_rate_recent": higher, "step": last} or learner.ckpt_best.all_steps() != [last]
                or len(saved_best) != n_saves + 1 or len(written) != 1):
            raise AssertionError(f"rotation after the fed window {(wr, eps)}: best_meta {fed_meta}, steps "
                                 f"{learner.ckpt_best.all_steps()}, saves {[s[:2] for s in saved_best]}")
    win, step, params = saved_best[-1]
    learner.close()
    seeded = Learner(cfg, actor="device", seed=seed + 1, device=device, registry=telemetry.Registry(),
                     init_from=best_dir)
    same = all(torch.equal(v.detach().cpu(), params[k]) for k, v in seeded.policy.state_dict().items())
    seeded.close()
    if not (same and seeded.init_from_step == step):
        raise AssertionError(f"init_from best/: step {seeded.init_from_step}, weights equal {same}")
    # the outcome curves: moved off their priors by the first window of
    # ended games, to the totals' rate (the 120 s window's base is empty)
    _, rows = read_record(jsonl)
    first = next((r for r in rows if r["outcome/episodes_recent"] >= 8), None)
    if first is None:
        raise AssertionError("no logged window holds 8 ended episodes")
    eps = sum(first[f"outcome/episodes/{b}"] for b in ("vs_scripted", "vs_league", "vs_selfplay"))
    wins = sum(first[f"outcome/wins/{b}"] for b in ("vs_scripted", "vs_league", "vs_selfplay"))
    if not (first["outcome/win_rate/overall"] == wins / eps and first["outcome/stream_age_s"] >= 0
            and first["outcome/episodes_total"] == eps and first["outcome/episode_len_p50"] > 0):
        raise AssertionError(f"outcome curves: overall {first['outcome/win_rate/overall']} against {wins}/{eps}, "
                             f"stream age {first['outcome/stream_age_s']}")
    best = {"meta": meta, "qualifying_windows": [(h["step"], h["win_rate_recent"], h["episodes_recent"])
                                                  for h in logged],
            "outcome": {k: first[k] for k in ("outcome/win_rate/overall", "outcome/win_rate/vs_scripted",
                                               "outcome/episodes_total", "outcome/episode_len_p50",
                                               "outcome/stream_age_s")},
            "fed_windows": fed, "fed_meta": fed_meta, "lstm_seq_launches": launches,
            "optimizer_steps": out["optimizer_steps"]}
    log(f"run record (d): {BEST_COLLECTS} collects, checkpoint_best_min_episodes {BEST_MIN_EPISODES}; qualifying "
        f"windows (step, win rate, episodes) {best['qualifying_windows']}; then fed (win rate, episodes) {fed}: "
        f"only the first moved best/, best_meta {fed_meta}; init_from best/ loads its weights bitwise; outcome "
        f"curves at the first window of ended games {best['outcome']}; "
        f"lstm_seq launches {launches} = {BEST_COLLECTS} x {T} + {passes:.0f} + {batches} x "
        f"{cfg.ppo.steps_per_batch}")
    return timing, best


def run_record_phase(device, seed, smi):
    """Phase 14: the run record and the rest of the checkpoint."""
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_record_") as root:
        result = record_child_phase(device, seed, root)
        result["save_timing"], result["best"] = record_inprocess_phase(device, seed, root, smi)
    result["wall_s"] = time.perf_counter() - t0
    result["lstm_seq_launches"] = result["best"]["lstm_seq_launches"]
    log(f"run record: phase 14 in {result['wall_s']:.1f} s")
    return result


# -- phase 15: external actors and the socket transport (BASELINE config 2) -----------

# (a): 64 self-play games, team size 1 (128 lanes), 20 s games; optimizer
# steps: warm, timed, profiled, and the overlap pass
VEC_ENVS, VEC_MAX_DOTA_TIME = 64, 20.0
VEC_WARM, VEC_TIMED, VEC_PROFILED, VEC_OVERLAP = 2, 8, 4, 8
VEC_TRACED = 8
# (b): actor processes, the learner's steps, the step lines at which one
# actor is killed and the others are stopped (the learner's console logs
# every 10 steps), and the staleness window. The others stop while the
# learner runs, so their flushed chunks land: it closes its server before
# its done: line. The 6 steps after the stop come from the ring (224
# chunks at step 30 in a CPU rehearsal) and the flushed partial chunks.
EXTERNAL_ACTORS, EXTERNAL_STEPS, EXTERNAL_KILL_AT, EXTERNAL_STOP_AT = 8, 36, 20, 30
EXTERNAL_STALENESS = 20
EXTERNAL_S = 300.0
# the fleet plane's cadence in (b) and 16 (c), seconds: the actors' (and the
# subscribed serve CLI's) snapshots, the actors' utilization folds and the
# learner's aggregator ticks, so the plane is folded and merged well before
# the kill (at the default 5 s an actor's first folded snapshot would land
# after it)
FLEET_INTERVAL = "1"
# the pipeline's hops in order (utils/trace_report.py)
CHUNK_HOPS = ("collect", "encode", "recv", "consume", "admit", "gather", "dispatch")
# in process a record rides the chunk's meta: no wire hops
IN_PROCESS_HOPS = ("collect", "encode", "admit", "gather", "dispatch")
SERVE_HOPS = ("encode", "recv", "reply", "done")


def vec_config(seed):
    from dotaclient_tpu_torch.config import RunConfig

    cfg = RunConfig()
    return dataclasses.replace(
        cfg, env=dataclasses.replace(cfg.env, n_envs=VEC_ENVS, opponent="selfplay", team_size=1,
                                     max_dota_time=VEC_MAX_DOTA_TIME),
        log_every=10 ** 9, seed=seed)


def ring_books(buf, batches, B):
    """The ring's books after a run: ingested = consumed + size + drops,
    with no skew, non-finite or bounds drop."""
    m = buf.metrics()
    if not (buf.ingested == batches * B + buf.size + buf.dropped_stale + buf.dropped_overflow
            and buf.dropped_skew == buf.dropped_nonfinite == buf.dropped_bounds == 0):
        raise AssertionError(f"ring books: {m} against {batches} batches x {B}")
    return m


def vec_phase(device, seed):
    """(a) the vec learner in process: sequential, profiled, overlapped."""
    import torch

    from dotaclient_tpu_torch.ops import lstm
    from dotaclient_tpu_torch.train.learner import Learner
    from dotaclient_tpu_torch.utils import telemetry

    cfg = vec_config(seed)
    T, B = cfg.ppo.rollout_len, cfg.ppo.batch_rollouts
    reg = telemetry.Registry()
    learner = Learner(cfg, actor="vec", seed=seed, device=device, registry=reg)
    pool, buf = learner.host_pool, learner.buffer
    if pool.n_lanes != 2 * VEC_ENVS:
        raise AssertionError(f"{pool.n_lanes} lanes, expected {2 * VEC_ENVS}")
    before = {k: v.detach().clone() for k, v in learner.policy.state_dict().items()}
    metrics, batches_seen = [], []
    optimize = learner._optimize

    def recording(batch):
        m = optimize(batch)
        metrics.append(m)
        batches_seen.append(batch)
        return m

    learner._optimize = recording
    torch.cuda.synchronize()
    lstm.lstm_sequence_kernel.launches = 0
    steps0 = pool.steps
    learner.train(VEC_WARM)
    torch.cuda.synchronize()
    env0, t0 = pool.env_steps, time.perf_counter()
    learner.train(VEC_TIMED)
    torch.cuda.synchronize()
    loop_s = time.perf_counter() - t0
    env_steps = pool.env_steps - env0
    pool_steps = pool.steps - steps0
    launches = lstm.lstm_sequence_kernel.launches
    updates = len(metrics)   # the warm and timed runs' updates
    passes = reg.snapshot()["advantage/passes_total"]
    if launches != pool_steps + updates + passes:
        raise AssertionError(f"lstm_seq launched {launches} times: expected {pool_steps} pool steps + {updates} "
                             f"updates + {passes:.0f} advantage passes")
    infer = reg.timer("span/actor/infer")
    infer_ms = infer.total / max(infer.count, 1) * 1e3
    profile = profiled(lambda: learner.train(VEC_PROFILED))
    t1, env1 = time.perf_counter(), pool.env_steps
    over = learner.train(VEC_OVERLAP, overlap=True, refresh_every=1)
    torch.cuda.synchronize()
    over_s, over_env = time.perf_counter() - t1, pool.env_steps - env1
    batches = VEC_WARM + VEC_TIMED + VEC_PROFILED + VEC_OVERLAP
    books = ring_books(buf, batches, B)
    for i, m in enumerate(metrics):
        m = {k: float(v) for k, v in m.items()}
        if not (np.isfinite(m["loss"]) and np.isfinite(m["grad_norm"]) and m["health_ok"] == 1.0):
            raise AssertionError(f"vec batch {i}: loss {m['loss']}, grad_norm {m['grad_norm']}, "
                                 f"health_ok {m['health_ok']}")
    moved, cast_legal, ability_choice = check_params_moved(before, learner.policy, batches_seen)
    moved = sum(moved.values())
    illegal, n_actions = check_chunk_actions(batches_seen)
    stats = pool.stats()
    if illegal or not (stats["episodes_done"] > 0 and len(metrics) == batches):
        raise AssertionError(f"vec: {illegal} of {n_actions} trained actions illegal, {stats['episodes_done']} "
                             f"episodes, {len(metrics)} batches")
    learner.close()
    frames = VEC_TIMED * B * T
    result = {
        "lanes": pool.n_lanes, "frames_trained": frames, "frames_per_s": frames / loop_s,
        "env_steps_per_s": env_steps / loop_s, "loop_ms": loop_s * 1e3, "pool_steps": pool_steps,
        "actor_infer_ms": infer_ms, "lstm_seq_launches": launches, "updates": updates,
        "overlap": {"frames_per_s": VEC_OVERLAP * B * T / over_s, "env_steps_per_s": over_env / over_s,
                    "optimizer_steps": over["optimizer_steps"]},
        "ring": books, "episodes_done": stats["episodes_done"], "params_moved": moved, "params": len(before),
        "actions_checked": n_actions, "frames_that_could_cast": cast_legal,
        "profile": {"optimizer_steps": VEC_PROFILED, **profile}, "last_loss": float(metrics[-1]["loss"]),
    }
    log(f"vec (a): {pool.n_lanes} lanes, {VEC_TIMED} timed steps alternating with the pool: {frames} trained frames "
        f"in {loop_s * 1e3:.1f} ms, {result['frames_per_s']:.0f} frames/s, the pool {result['env_steps_per_s']:.0f} env "
        f"steps/s, span/actor/infer {infer_ms:.3f} ms mean over {infer.count} steps; overlap: "
        f"{result['overlap']['frames_per_s']:.0f} frames/s, the pool {result['overlap']['env_steps_per_s']:.0f} env "
        f"steps/s; ring {books}; lstm_seq launches {launches} = {pool_steps} pool steps + {updates} updates + "
        f"{passes:.0f} passes; {moved} of {len(before)} params moved, {n_actions} trained actions legal, "
        f"{stats['episodes_done']:.0f} episodes")
    log_profile(f"vec profile: {VEC_PROFILED} steps", profile)
    return result


def traced_vec_phase(device, seed, root):
    """(a') the vec learner traced at sample 1, its train loop under the
    sync guard: the learner-side trace sites run beside the card's work
    with the guard on. The pool's steps copy to and from the card by
    design, so the guard is lifted around them; the snapshot engine's
    copies to the host wait until the end of ``train`` lifts it."""
    import os
    import threading

    import torch

    from dotaclient_tpu_torch.ops import lstm
    from dotaclient_tpu_torch.train.learner import Learner
    from dotaclient_tpu_torch.utils import telemetry, trace_report, tracing

    path = os.path.join(root, "trace_vec.jsonl")
    reg = telemetry.Registry()
    gate = threading.Event()
    tracing.configure(path, sample_n=1, registry=reg)
    try:
        learner = Learner(vec_config(seed), actor="vec", seed=seed, device=device, registry=reg)
        pool, engine = learner.host_pool, learner._snap_engine
        run, fetch = pool.run, engine._fetch

        def lifted_run(*args, **kwargs):
            mode = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode(0)
            try:
                return run(*args, **kwargs)
            finally:
                torch.cuda.set_sync_debug_mode(mode)

        def held_fetch(copy):
            if not gate.wait(WAIT_S):
                raise AssertionError(f"the snapshot engine's copy was held past {WAIT_S:.0f} s")
            return fetch(copy)

        pool.run, engine._fetch = lifted_run, held_fetch
        unguarded_end(learner, on_lift=gate.set)
        torch.cuda.synchronize()
        lstm.lstm_sequence_kernel.launches = 0
        _, loop_s = guarded_train(learner, VEC_TRACED)
        launches = lstm.lstm_sequence_kernel.launches
        learner.close()
    finally:
        gate.set()
        tracing.shutdown()
    dropped = reg.snapshot()["trace/dropped_total"]
    events, skipped = trace_report.load_events([path])
    chunks = trace_report.merge_chunks(events)
    complete = [c["hops"] for c in chunks.values() if all(h in c["hops"] for h in IN_PROCESS_HOPS)]
    disordered = [h for h in complete if not ordered(h, IN_PROCESS_HOPS)]
    if not complete or disordered or dropped != 0.0 or skipped or launches == 0:
        raise AssertionError(f"traced vec learner: {len(complete)} complete chunk timelines of {len(chunks)}, "
                             f"{len(disordered)} out of order {disordered[:2]}, trace/dropped_total {dropped}, "
                             f"{skipped} lines skipped, lstm_seq launches {launches}")
    result = {"optimizer_steps": VEC_TRACED, "loop_ms": loop_s * 1e3, "chunks_traced": len(chunks),
              "chunks_complete": len(complete), "events": len(events), "lstm_seq_launches": launches}
    log(f"vec (a'), traced at sample 1 under the sync guard: {VEC_TRACED} optimizer steps in {loop_s * 1e3:.1f} ms, "
        f"{len(complete)} of {len(chunks)} chunk timelines complete (collect <= encode <= admit <= gather <= "
        f"dispatch), {len(events)} events, trace/dropped_total 0; lstm_seq launches {launches}")
    return result


def free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def learner_step(lines):
    """The last optimizer step the learner CLI's console lines reached."""
    import re

    steps = [int(m.group(1)) for m in (re.match(r"\[\s*[\d.]+s\] step (\d+):", x) for x in lines) if m]
    return max(steps, default=0)


def wait_step(learner_child, step, deadline):
    while learner_step(learner_child.lines()) < step:
        if learner_child.proc.poll() is not None:
            raise AssertionError(f"the learner exited ({learner_child.proc.returncode}) before step {step}: "
                                 f"{learner_child.stderr()[-2000:]}")
        if time.perf_counter() > deadline:
            raise AssertionError(f"the learner did not reach step {step} within {EXTERNAL_S:.0f} s")
        time.sleep(0.05)
    return time.perf_counter()


def cpu_seconds(pid):
    """(CPU seconds of a process, of its main thread) from ``/proc``: user
    plus system time, every thread's in the first. None where ``/proc``
    does not have them."""
    import os

    tick = os.sysconf("SC_CLK_TCK")

    def read(path):
        with open(path) as f:
            fields = f.read().rsplit(")", 1)[1].split()
        return (int(fields[11]) + int(fields[12])) / tick

    try:
        return read(f"/proc/{pid}/stat"), read(f"/proc/{pid}/task/{pid}/stat")
    except (OSError, IndexError, ValueError):
        return None


def host_sample(learner_child, actors):
    """A sample of the children's CPU clocks: (wall, the learner's, the
    learner's main (train) thread's, the actors' summed), None if any is
    unreadable."""
    learner, main = cpu_seconds(learner_child.proc.pid) or (None, None)
    each = [cpu_seconds(a.proc.pid) for a in actors]
    if learner is None or any(c is None for c in each):
        return None
    return time.perf_counter(), learner, main, sum(c[0] for c in each)


# the spans of the learner's train thread whose share of a window phase 15
# reports: the ingest (the transport's drain, the decode, the ring's host
# rows) and the host's time launching the update
TRAIN_SPANS = ("learner/consume", "transport/consume", "buffer/stage", "buffer/insert", "learner/dispatch")


def learner_window(raw, step_a, step_b, cpu_a, cpu_b):
    """The external learner child's window between its log lines at
    ``step_a`` and ``step_b``: each TRAIN_SPANS span's share of the
    record's wall clock, the train thread's ``util/phase/*`` at ``step_b``,
    and the CPU cores the learner process, its train thread and the actors
    used (from two ``host_sample``s; "not measured" without them)."""
    import os

    at = {}
    for line in raw:
        row = json.loads(line)
        if "scalars" in row and row.get("step") in (step_a, step_b):
            at[row["step"]] = row
    a, b = at[step_a], at[step_b]
    wall = b["ts"] - a["ts"]
    shares = {name: (b["scalars"].get(f"span/{name}/total_s", 0.0) - a["scalars"].get(f"span/{name}/total_s", 0.0))
              / wall for name in TRAIN_SPANS}
    phases = {k[len("util/phase/"):]: v for k, v in b["scalars"].items() if k.startswith("util/phase/")}
    out = {"steps": [step_a, step_b], "record_wall_s": wall, "span_shares": shares, "util_phases": phases}
    if cpu_a is None or cpu_b is None:
        out["cores"] = "not measured"
        return out
    dt = cpu_b[0] - cpu_a[0]
    learner, main, actors = ((cpu_b[i] - cpu_a[i]) / dt for i in (1, 2, 3))
    out["cores"] = {"wall_s": dt, "learner": learner, "train_thread": main, "learner_other_threads": learner - main,
                    "actors": actors, "host_cores": os.cpu_count()}
    return out


def actor_closing(child):
    """An actor child's closing lines: (versions applied, its stats)."""
    lines = child.lines()
    seen = [json.loads(x.split(" ", 1)[1]) for x in lines if x.startswith("ACTOR_VERSIONS_SEEN ")]
    stats = [json.loads(x.split(" ", 1)[1]) for x in lines if x.startswith("ACTOR_STATS ")]
    if not (seen and stats):
        raise AssertionError(f"{child.name} printed no closing lines: {lines[-3:]} {child.stderr()[-1500:]}")
    if not (stats[-1]["native_encodes"] > 0 and stats[-1]["proto_fallbacks"] == 0):
        raise AssertionError(f"{child.name}'s rollout codec: {stats[-1]} (native encodes and no fallback expected)")
    return seen[-1], stats[-1]


def shm_leftovers(name):
    """The files of shm lane ``name`` (segments and slot lockfiles) in
    /dev/shm."""
    import os

    return sorted(f for f in os.listdir("/dev/shm") if f.startswith(f"{name}-"))


def fleet_plane(raw, seed, n_peers):
    """The learner record's fleet plane on its last line at or before the
    kill's step (ROADMAP item 8's card check): ``fleet/peers`` equal to the
    live peers (the actors, and a subscribed serve CLI), each actor's
    ``fleet/a<seed>/util/actor/*`` keys present, each in [0, 1] and folded
    (summing to 1 within 0.01), and the outcome window armed (at least 8
    episodes) with the win rate at the counters' rate: rate x episodes a
    whole number of wins, no more than the line's win counters hold (the
    learner's own and every ``fleet/<peer>/outcome/wins/*`` mirror), so a
    curve left at its 0.5 prior with no win counted fails."""
    from dotaclient_tpu_torch.outcome.records import BUCKETS
    from dotaclient_tpu_torch.utils.utilization import ACTOR_PHASES

    lines = [json.loads(x) for x in raw if '"scalars"' in x]
    before = [x for x in lines if 0 < x.get("step", 0) <= EXTERNAL_KILL_AT]
    if not before:
        raise AssertionError(f"no record line at or before step {EXTERNAL_KILL_AT}")
    step, s = before[-1]["step"], before[-1]["scalars"]
    labels = [f"a{seed + 1 + i}" for i in range(EXTERNAL_ACTORS)]
    util = {p: [s.get(f"fleet/{p}/util/actor/{ph}") for ph in ACTOR_PHASES] for p in labels}
    bad = {p: v for p, v in util.items()
           if None in v or not (all(0.0 <= x <= 1.0 for x in v) and 0.99 <= sum(v) <= 1.01)}
    if bad or s.get("fleet/peers") != n_peers:
        raise AssertionError(f"the fleet plane at step {step}: fleet/peers {s.get('fleet/peers')} (expected "
                             f"{n_peers}), util/actor of the actors not present or folded: {bad}")
    ends = tuple(f"outcome/wins/{b}" for b in BUCKETS)
    wins = sum(v for k, v in s.items() if k in ends or (k.startswith("fleet/") and k.endswith(ends)))
    rate, eps = s["outcome/win_rate/overall"], s["outcome/episodes_recent"]
    missing = [p for p in labels if f"fleet/{p}/outcome/wins/vs_selfplay" not in s]
    if missing or not (eps >= 8 and 0.0 <= rate <= 1.0 and abs(rate * eps - round(rate * eps)) < 1e-6
                       and round(rate * eps) <= wins):
        raise AssertionError(f"the outcome window at step {step}: {eps} episodes, win rate {rate}, the win "
                             f"counters {wins}, actors without one {missing}")
    mean = {ph: float(np.mean([util[p][i] for p in labels])) for i, ph in enumerate(ACTOR_PHASES)}
    return {"step": step, "peers": s["fleet/peers"], "util_actor_mean": mean,
            "util_actor_ship_wait_max": s["fleet/agg/ship_wait/max"],
            "win_rate_overall": rate, "episodes_recent": eps, "wins_counted": wins}


def ordered(hops, names):
    """True iff ``hops`` (name -> stamp) holds every name, stamps in order."""
    return all(n in hops for n in names) and all(hops[a] <= hops[b] for a, b in zip(names, names[1:]))


def chunk_traces(trace_dir, last, actors, labels):
    """Phase 16 (c)'s trace logs joined (``utils/trace_report.py``): at least
    one complete chunk timeline, every complete one in hop order; no trace
    event dropped (the learner's ``trace/dropped_total``, and
    ``fleet/<label>/trace/dropped_total`` of each surviving actor's fleet
    row, each present and 0); an ``apply`` event with a publish stamp in
    each surviving actor's log. Returns each leg's median ms."""
    from dotaclient_tpu_torch.utils import trace_report

    events, _ = trace_report.load_events([trace_dir])
    report = trace_report.build_report([trace_dir])
    chunks = trace_report.merge_chunks(events)
    complete = [c["hops"] for c in chunks.values() if all(h in c["hops"] for h in CHUNK_HOPS)]
    disordered = [h for h in complete if not ordered(h, CHUNK_HOPS)]
    if not complete or disordered:
        raise AssertionError(f"{len(complete)} complete chunk timelines, {len(disordered)} out of order: "
                             f"{disordered[:2]}")
    keys = ["trace/dropped_total", *(f"fleet/{p}/trace/dropped_total" for p in labels)]
    dropped = {k: last.get(k) for k in keys}
    if any(v != 0.0 for v in dropped.values()):
        raise AssertionError(f"trace events dropped, or a counter missing (None): {dropped}")
    lags = []
    for a in actors:
        applies = [e for e in events if e["event"] == "apply" and e["pid"] == a.proc.pid
                   and isinstance(e.get("publish_ts"), float)]
        if not applies:
            raise AssertionError(f"{a.name}'s trace log holds no apply event with a publish stamp")
        lags += [e["ts"] - e["publish_ts"] for e in applies]
    cp = report["critical_path"]
    legs = {"actor compute": cp["actor compute"]["p50"], "wire": cp["wire"]["p50"],
            "decode": cp["drain wait"]["p50"], "admission": cp["admission"]["p50"],
            "ring residency": cp["ring residency"]["p50"], "gather->dispatch": cp["dispatch wait"]["p50"],
            "publish->apply": float(np.median(lags)), "collect->dispatch": report["e2e_latency_s"]["p50"]}
    return {"chunks_complete": len(complete), "chunks_seen": report["chunks_seen"], "events": report["events"],
            "lines_skipped": report["lines_skipped"], "applies": len(lags), "dropped": dropped,
            "legs_p50_ms": {k: v * 1e3 for k, v in legs.items()}}


def external_phase(device, seed, root, lane="socket", subscriber_ckpt=None, traced=False, smi=""):
    """(b) BASELINE config 2: a learner CLI child fed by actor CLI children
    over TCP (``lane`` "socket"), or over its shared-memory lane on this
    host ("shm", phase 16 (c)), one actor killed and the rest stopped while
    it trains. With ``subscriber_ckpt``, a serve CLI child on that
    checkpoint subscribes to the lane's weights and must apply a version the
    learner published. Every run reads the fleet plane (``fleet_plane``);
    with ``traced`` the learner and the actors write trace logs, joined by
    ``chunk_traces``."""
    import os
    import signal

    from dotaclient_tpu_torch.config import RunConfig

    if lane == "socket":
        connect = f"127.0.0.1:{free_port()}"
        lane_args, ready = ["--transport", "socket", "--listen", connect], "learner: listening for actors on"
    else:
        name = f"chip-smoke-{os.getpid()}-{seed}"
        connect = f"shm://{name}"
        lane_args, ready = ["--transport", "shm", "--shm-name", name], "learner: shm lane"
    jsonl = os.path.join(root, f"external_{lane}.jsonl")
    trace_dir = os.path.join(root, f"trace_{lane}")
    if traced:
        os.makedirs(trace_dir)

    def trace_args(name):
        return ["--trace-jsonl", os.path.join(trace_dir, f"{name}.jsonl")] if traced else []

    t0 = time.perf_counter()
    deadline = t0 + EXTERNAL_S
    children = []
    serve = None
    try:
        learner = ModuleChild("dotaclient_tpu_torch.train.learner", [
            "--actor", "external", *lane_args, "--steps", str(EXTERNAL_STEPS), "--seed", str(seed),
            "--metrics-jsonl", jsonl, "--buffer", f"max_weight_staleness={EXTERNAL_STALENESS}",
            "--fleet-interval", FLEET_INTERVAL, *trace_args(f"learner_{lane}")],
            root, f"learner_{lane}")
        children.append(learner)
        while not any(x.startswith(ready) for x in learner.lines()):
            if learner.proc.poll() is not None or time.perf_counter() > deadline:
                raise AssertionError(f"the learner never served its lane: {learner.stderr()[-2000:]}")
            time.sleep(0.05)
        t_listen = time.perf_counter()
        if subscriber_ckpt is not None:
            serve = ModuleChild("dotaclient_tpu_torch.serve", [
                "--checkpoint", subscriber_ckpt, "--subscribe", connect, "--serve-listen", "127.0.0.1:0",
                "--fleet-interval", FLEET_INTERVAL], root, f"serve_{lane}")
            children.append(serve)
        actors = [ModuleChild("dotaclient_tpu_torch.actor", [
            "--connect", connect, "--n-envs", str(VEC_ENVS), "--opponent", "selfplay", "--max-dota-time",
            str(VEC_MAX_DOTA_TIME), "--platform", "cuda", "--seed", str(seed + 1 + i), "--fleet-interval",
            FLEET_INTERVAL, *trace_args(f"actor{i}_{lane}")], root, f"actor{i}_{lane}")
            for i in range(EXTERNAL_ACTORS)]
        children += actors
        t_actors = time.perf_counter()
        t_first = wait_step(learner, 10, deadline)
        cpu_first = host_sample(learner, actors)
        t_kill = wait_step(learner, EXTERNAL_KILL_AT, deadline)
        cpu_kill = host_sample(learner, actors)
        actors[0].proc.send_signal(signal.SIGKILL)
        # reaped at once: a lane sees the pid gone only once its zombie is
        if actors[0].proc.wait(timeout=30) != -signal.SIGKILL:
            raise AssertionError(f"actor0 exit {actors[0].proc.returncode}, expected SIGKILL")
        t_stop = wait_step(learner, EXTERNAL_STOP_AT, deadline)
        for a in actors[1:]:
            a.proc.send_signal(signal.SIGTERM)
        closing = []
        for a in actors[1:]:
            rc = a.wait(max(1.0, deadline - time.perf_counter()))
            if rc != 0 or "graceful stop: flushed" not in a.stderr():
                raise AssertionError(f"{a.name} exited {rc}: {a.stderr()[-1500:]}")
            closing.append(actor_closing(a))
        t_actors_out = time.perf_counter()
        rc = learner.wait(max(1.0, deadline - time.perf_counter()))
        t_done = time.perf_counter()
        if rc != 0:
            raise AssertionError(f"the learner exited {rc}: {learner.stderr()[-3000:]}")
        done = done_fields(learner.lines(), f"the external learner ({lane})")
        steps, frames, launched = done["steps"], done["frames"], done["launches"]
        subscribed = None
        if serve is not None:
            serve.proc.send_signal(signal.SIGINT)
            rc = serve.wait(max(1.0, deadline - time.perf_counter()))
            if rc != 0:
                raise AssertionError(f"the subscribed serve CLI exited {rc}: {serve.stderr()[-2000:]}")
            subscribed = no_codec_fallback(json.loads(serve.lines()[-1]), "the subscribed serve CLI")
    finally:
        for c in children:
            c.kill()
        leftovers = shm_leftovers(name) if lane == "shm" else []
        for f in leftovers:
            # cleanup only: the check below fails the phase all the same
            os.unlink(os.path.join("/dev/shm", f))
    if leftovers:
        raise AssertionError(f"shm lane {name!r} left {leftovers} in /dev/shm")
    raw, rows = read_record(jsonl)
    last = rows[-1]
    window = learner_window(raw, 10, EXTERNAL_KILL_AT, cpu_first, cpu_kill)
    plane = fleet_plane(raw, seed, EXTERNAL_ACTORS + (serve is not None))
    traces = (chunk_traces(trace_dir, last, actors[1:], [f"a{seed + 1 + i}" for i in range(1, EXTERNAL_ACTORS)])
              if traced else None)
    cfg = RunConfig()
    updates = steps * cfg.ppo.epochs_per_batch * max(1, cfg.ppo.minibatches)
    passes = last["advantage/passes_total"]
    if launched != updates + passes:
        raise AssertionError(f"the external learner launched lstm_seq {launched} times: expected {updates} "
                             f"updates + {passes:.0f} advantage passes")
    bad = {k: last[k] for k in ("buffer/dropped_skew", "buffer/dropped_nonfinite", "buffer/dropped_bounds",
                                "transport/malformed_payloads_total")}
    if not (steps == EXTERNAL_STEPS and last["transport/rollout_bytes_total"] > 0 and not any(bad.values())
            and last["buffer/batch_staleness"] < EXTERNAL_STEPS and done["native_decodes"] > 0):
        raise AssertionError(f"the external learner: {steps} steps, rollout bytes "
                             f"{last['transport/rollout_bytes_total']}, drops {bad}, batch staleness "
                             f"{last['buffer/batch_staleness']}")
    for seen, st in closing:
        if not (max(seen) > 0 and st["lstm_seq_launches"] == st["steps"] > 0 and st["rollouts_shipped"] > 0):
            raise AssertionError(f"an actor's closing lines: versions {seen}, stats {st}")
    reaped = last.get("shm/slots_reaped", 0.0)
    if lane == "shm" and reaped < 1:
        raise AssertionError(f"the SIGKILLed actor's shm slot was not reaped (shm/slots_reaped {reaped})")
    ckpt_step = None
    if subscribed is not None:
        from dotaclient_tpu_torch.utils import telemetry
        from dotaclient_tpu_torch.utils.checkpoint import CheckpointManager

        ckpt_step = CheckpointManager(subscriber_ckpt, registry=telemetry.Registry()).latest_step()
        # its checkpoint's step is its first version: a later one came from the lane
        if not (subscribed["serve_weights_version"] > ckpt_step
                and subscribed["lstm_seq_launches"] - 1 == subscribed["serve_dispatches_total"]):
            raise AssertionError(f"the subscribed serve CLI's last line {subscribed}: expected a version above "
                                 f"its checkpoint's {ckpt_step}, launches = dispatches + its warm-up")
    elapsed = last["elapsed_sec"]
    ingested = last["buffer/ingested"]
    frames_per_step = frames / steps
    # between the step-10 and step-30 lines: every actor up, none stopped
    # (the kill at step 20 included)
    steady = (EXTERNAL_STOP_AT - 10) * frames_per_step / (t_stop - t_first)
    result = {
        "lane": lane, "actors": EXTERNAL_ACTORS, "steps": steps, "frames": frames,
        "frames_per_s": last["frames_per_sec"], "frames_per_s_steps_10_to_30": steady,
        "train_elapsed_s": elapsed, "rollouts_ingested": ingested, "rollouts_ingested_per_s": ingested / elapsed,
        "dropped_stale": last["buffer/dropped_stale"], "dropped_overflow": last["buffer/dropped_overflow"],
        "transport_dropped": last.get("transport/experience_dropped", 0.0),
        "ring_full_dropped": last.get("shm/ring_dropped_total", 0.0), "slots_reaped": reaped,
        "rollout_bytes": last["transport/rollout_bytes_total"], "publish_stall_ms": last["learner/publish_stall_ms"],
        "batch_staleness": last["buffer/batch_staleness"], "weights_published": last["transport/weights_published"],
        "actors_closing": [{"versions_seen": s, **st} for s, st in closing],
        "lstm_seq_launches": launched, "advantage_passes": passes,
        "actors_lstm_seq_launches": sum(st["lstm_seq_launches"] for _, st in closing),
        "ring_bytes": last["buffer/shard_bytes"],
        "codec": {k: done[k] for k in ("native_decodes", "native_encodes", "proto_fallbacks")},
        "actors_codec": {k: sum(st[k] for _, st in closing) for k in ("native_encodes", "proto_fallbacks")},
        "window_steps_10_to_20": window, "fleet_plane": plane, "traces": traces,
        "wall_s": {"learner_listening": t_listen - t0, "actors_started": t_actors - t0,
                   "first_10_steps": t_first - t_actors, "to_kill": t_kill - t0, "to_stop": t_stop - t0,
                   "actors_out": t_actors_out - t0, "done": t_done - t0},
    }
    if subscribed is not None:
        result["subscriber"] = {"checkpoint_step": ckpt_step, **subscribed}
    ships = ", ".join(f"{st['rollouts_shipped']:.0f} chunks at {st['env_steps_per_sec']:.0f} env steps/s "
                      f"(start {a.wall_s - st['elapsed_sec']:.1f} s)" for a, (_, st) in zip(actors[1:], closing))
    drops = (f"transport drop-oldest {result['transport_dropped']:.0f}" if lane == "socket" else
             f"ring-full drops {result['ring_full_dropped']:.0f}, slots reaped {reaped:.0f}")
    log(f"external ({lane}): {EXTERNAL_ACTORS} actor processes x {2 * VEC_ENVS} lanes into the learner CLI over "
        f"{'127.0.0.1' if lane == 'socket' else 'shared memory'}: {steps} steps, {frames} frames, "
        f"{result['frames_per_s']:.0f} trained frames/s over {elapsed:.1f} s of train ({steady:.0f} between the "
        f"step-10 and step-30 lines); {ingested:.0f} rollouts ingested ({result['rollouts_ingested_per_s']:.0f}/s), "
        f"stale drops {result['dropped_stale']:.0f}, ring overflow {result['dropped_overflow']:.0f}, {drops}; "
        f"skew, non-finite, malformed 0; {result['rollout_bytes']:.0f} rollout bytes; "
        f"{result['weights_published']:.0f} weights publishes, learner/publish_stall_ms "
        f"{result['publish_stall_ms']:.3f}; last batch staleness {result['batch_staleness']:.1f}; actor0 SIGKILLed "
        f"at step {EXTERNAL_KILL_AT}, the other {EXTERNAL_ACTORS - 1} stopped at step {EXTERNAL_STOP_AT}, flushed "
        f"and exited 0: {ships}; lstm_seq launches {launched} in the learner = {updates} updates + {passes:.0f} "
        f"passes, {result['actors_lstm_seq_launches']:.0f} in the {EXTERNAL_ACTORS - 1} closed actors; the rollout "
        f"codec: the learner {result['codec']}, the closed actors {result['actors_codec']}; wall "
        + ", ".join(f"{k} {v:.1f} s" for k, v in result["wall_s"].items())
        + (f"; the subscribed serve CLI applied version {subscribed['serve_weights_version']:.0f} (its checkpoint "
           f"step {ckpt_step}), {subscribed['serve_dispatches_total']:.0f} dispatches" if subscribed else ""))
    log(f"external ({lane}), the fleet plane on the learner's step-{plane['step']} line (before the kill): "
        f"fleet/peers {plane['peers']:.0f}; util/actor, the actors' mean: "
        + ", ".join(f"{k} {v:.4f}" for k, v in plane["util_actor_mean"].items())
        + f"; ship_wait max {plane['util_actor_ship_wait_max']:.4f}; outcome/win_rate/overall "
        f"{plane['win_rate_overall']:.4f} over {plane['episodes_recent']:.0f} episodes; {smi}")
    if traces is not None:
        log(f"external ({lane}), traced (sample 16): {traces['chunks_complete']} complete chunk timelines in hop "
            f"order of {traces['chunks_seen']} traced, {traces['events']} events, {traces['lines_skipped']} lines "
            f"skipped, {traces['applies']} applies with a publish stamp, trace/dropped_total 0; median ms: "
            + ", ".join(f"{k} {v:.3f}" for k, v in traces["legs_p50_ms"].items()) + f"; {smi}")
    cores = window["cores"]
    log(f"external ({lane}), the learner's steps 10-20 ({window['record_wall_s']:.2f} s by its record): span shares "
        + ", ".join(f"{k} {v:.4f}" for k, v in window["span_shares"].items()) + "; util/phase "
        + ", ".join(f"{k} {v:.4f}" for k, v in window["util_phases"].items()) + "; CPU cores "
        + (", ".join(f"{k} {v:.3f}" for k, v in cores.items()) if isinstance(cores, dict) else cores))
    return result


def external_actors_phase(device, seed, smi=""):
    """Phase 15: the vec learner in process, untraced and then traced under
    the sync guard, then BASELINE config 2 across processes (untraced)."""
    t0 = time.perf_counter()
    result = {"vec": vec_phase(device, seed)}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_external_") as root:
        result["vec_traced"] = traced_vec_phase(device, seed, root)
        result["external"] = external_phase(device, seed, root, smi=smi)
    result["wall_s"] = time.perf_counter() - t0
    log(f"external actors: phase 15 in {result['wall_s']:.1f} s")
    return result


# -- phase 16: the scalar path (BASELINE config 1) and the shm lane ----------------------

# (a): the reference's defaults (8 games, the easy bot, batches of 32, 1 x 1
# updates) with games of 20 s; optimizer steps: warm, timed alternating with
# the pool, overlapped. (a'): the CLI's steps, and the --no-vec child's.
# (b): served games against the hard bot.
SCALAR_MAX_DOTA_TIME = 20.0
SCALAR_WARM, SCALAR_TIMED, SCALAR_OVERLAP = 1, 3, 3
SCALAR_CLI_STEPS, SCALAR_NOVEC_STEPS = 10, 10   # 10: one log line (log_every 10)
EVAL_SERVED_GAMES = 8


def grpc_check():
    """The gRPC fake dotaservice where this machine has ``grpc``: one
    reset, five acts and an observe over 127.0.0.1. Its parity with the
    JAX package's is held in the CPU tests."""
    import importlib.util

    if importlib.util.find_spec("grpc") is None:
        log("grpc: not installed here; the gRPC fake dotaservice is not driven on this machine")
        return {"grpc": False}
    import asyncio

    from dotaclient_tpu_torch.envs import service
    from dotaclient_tpu_torch.protos import dota_pb2 as pb

    async def cycle():
        server, port = await service.serve_env()
        client = service.DotaServiceClient.connect(f"127.0.0.1:{port}")
        try:
            init = await client.reset(pb.GameConfig(seed=1))
            for _ in range(5):
                await client.act(pb.Actions(team_id=2, actions=[pb.Action(player_id=0, type=pb.ACTION_MOVE,
                                                                          move_x=8, move_y=4)]))
            return init, await client.observe(2)
        finally:
            await client.close()
            await server.stop(None)

    t0 = time.perf_counter()
    init, obs = asyncio.run(cycle())
    ms = (time.perf_counter() - t0) * 1e3
    if not (init.status == pb.STATUS_OK and obs.status == pb.STATUS_OK and obs.world_state.tick == 5 * 6):
        raise AssertionError(f"gRPC cycle: reset {init.status}, observe {obs.status} at tick {obs.world_state.tick}")
    log(f"grpc: installed; a reset, 5 acts and an observe over 127.0.0.1 in {ms:.1f} ms")
    return {"grpc": True, "cycle_ms": ms}


def scalar_config(seed):
    from dotaclient_tpu_torch.config import RunConfig

    cfg = RunConfig()
    return dataclasses.replace(cfg, env=dataclasses.replace(cfg.env, max_dota_time=SCALAR_MAX_DOTA_TIME),
                               log_every=10 ** 9, seed=seed)


def scalar_phase(device, seed):
    """(a) BASELINE config 1 in process: ``Learner(actor="scalar")``,
    sequential then overlapped."""
    import torch

    from dotaclient_tpu_torch.ops import lstm
    from dotaclient_tpu_torch.train.learner import Learner
    from dotaclient_tpu_torch.utils import telemetry

    cfg = scalar_config(seed)
    T, B = cfg.ppo.rollout_len, cfg.ppo.batch_rollouts
    reg = telemetry.Registry()
    learner = Learner(cfg, actor="scalar", seed=seed, device=device, registry=reg)
    pool, buf = learner.host_pool, learner.buffer
    if pool.n_lanes != SCALAR_LANES:
        raise AssertionError(f"{pool.n_lanes} lanes, expected {SCALAR_LANES}")
    before = {k: v.detach().clone() for k, v in learner.policy.state_dict().items()}
    metrics, batches_seen, versions = [], [], []
    optimize, add = learner._optimize, buf.add

    def recording(batch):
        m = optimize(batch)
        metrics.append(m)
        batches_seen.append(batch)
        return m

    def adding(rows, version):
        versions.extend(meta["model_version"] for meta, _ in rows)
        return add(rows, version)

    learner._optimize, buf.add = recording, adding
    torch.cuda.synchronize()
    lstm.lstm_sequence_kernel.launches = 0
    steps0 = pool.steps
    learner.train(SCALAR_WARM)
    torch.cuda.synchronize()
    step_t, infer_t = reg.timer("span/actor/step"), reg.timer("span/actor/infer")
    env0, pool0, t0 = pool.env_steps, pool.steps, time.perf_counter()
    step0, infer0 = (step_t.total, step_t.count), (infer_t.total, infer_t.count)
    learner.train(SCALAR_TIMED)
    torch.cuda.synchronize()
    loop_s = time.perf_counter() - t0
    env_steps, timed_pool_steps = pool.env_steps - env0, pool.steps - pool0
    step_ms = (step_t.total - step0[0]) / max(step_t.count - step0[1], 1) * 1e3
    infer_ms = (infer_t.total - infer0[0]) / max(infer_t.count - infer0[1], 1) * 1e3
    t1, env1 = time.perf_counter(), pool.env_steps
    over = learner.train(SCALAR_OVERLAP, overlap=True, refresh_every=1)
    torch.cuda.synchronize()
    over_s, over_env = time.perf_counter() - t1, pool.env_steps - env1
    pool_steps = pool.steps - steps0   # the overlap's thread has joined
    launches = lstm.lstm_sequence_kernel.launches
    updates = len(metrics)
    passes = reg.snapshot()["advantage/passes_total"]
    if launches != pool_steps + updates + passes:
        raise AssertionError(f"lstm_seq launched {launches} times: expected {pool_steps} pool steps + {updates} "
                             f"updates + {passes:.0f} advantage passes")
    batches = SCALAR_WARM + SCALAR_TIMED + SCALAR_OVERLAP
    books = ring_books(buf, batches, B)
    for i, m in enumerate(metrics):
        m = {k: float(v) for k, v in m.items()}
        if not (np.isfinite(m["loss"]) and np.isfinite(m["grad_norm"]) and m["health_ok"] == 1.0):
            raise AssertionError(f"scalar batch {i}: loss {m['loss']}, grad_norm {m['grad_norm']}, "
                                 f"health_ok {m['health_ok']}")
    moved, cast_legal, _ = check_params_moved(before, learner.policy, batches_seen)
    moved = sum(moved.values())
    illegal, n_actions = check_chunk_actions(batches_seen)
    stats = pool.stats()
    if illegal or not (stats["episodes_done"] > 0 and len(metrics) == batches and max(versions) > 0):
        raise AssertionError(f"scalar: {illegal} of {n_actions} trained actions illegal, {stats['episodes_done']} "
                             f"episodes, {len(metrics)} batches, chunk versions up to {max(versions)}")
    learner.close()
    frames = SCALAR_TIMED * B * T
    result = {
        "lanes": pool.n_lanes, "frames_trained": frames, "frames_per_s": frames / loop_s,
        "env_steps_per_s": env_steps / loop_s, "loop_ms": loop_s * 1e3, "timed_pool_steps": timed_pool_steps,
        "actor_step_ms": step_ms, "actor_infer_ms": infer_ms, "infer_share_of_step": infer_ms / step_ms,
        "pool_steps": pool_steps, "lstm_seq_launches": launches, "updates": updates, "advantage_passes": passes,
        "overlap": {"frames_per_s": SCALAR_OVERLAP * B * T / over_s, "env_steps_per_s": over_env / over_s,
                    "optimizer_steps": over["optimizer_steps"]},
        "ring": books, "episodes_done": stats["episodes_done"], "win_rate": stats["win_rate"],
        "params_moved": moved, "params": len(before), "actions_checked": n_actions,
        "frames_that_could_cast": cast_legal, "chunk_versions_max": max(versions),
        "last_loss": float(metrics[-1]["loss"]),
    }
    log(f"scalar (a), BASELINE config 1: {pool.n_lanes} lanes, {SCALAR_TIMED} timed steps alternating with the pool: "
        f"{frames} trained frames in {loop_s * 1e3:.1f} ms, {result['frames_per_s']:.0f} frames/s, the pool "
        f"{result['env_steps_per_s']:.0f} env steps/s ({timed_pool_steps} pool steps), span/actor/step "
        f"{step_ms:.3f} ms of which span/actor/infer {infer_ms:.3f} ms ({infer_ms / step_ms:.3f}); overlap: "
        f"{result['overlap']['frames_per_s']:.0f} frames/s, the pool {result['overlap']['env_steps_per_s']:.0f} env "
        f"steps/s; ring {books}; lstm_seq launches {launches} = {pool_steps} pool steps + {updates} updates + "
        f"{passes:.0f} passes; {moved} of {len(before)} params moved, {n_actions} trained actions legal, "
        f"{stats['episodes_done']:.0f} episodes, chunk versions up to {max(versions)}")
    return result


SCALAR_CLI_RUNS = {"scalar": (["--actor", "scalar"], SCALAR_CLI_STEPS), "no_vec": (["--no-vec"], SCALAR_NOVEC_STEPS)}


def scalar_cli_start(seed, root):
    """(a')'s children: the learner CLI with ``--actor scalar`` (its
    checkpoint feeds (b)) and, beside it, with ``--no-vec``."""
    import os

    children = {}
    try:
        for name, (flags, steps) in SCALAR_CLI_RUNS.items():
            jsonl = os.path.join(root, f"{name}.jsonl")
            ckpt = ["--checkpoint-dir", os.path.join(root, "scalar_ckpt")] if name == "scalar" else []
            children[name] = (RecordChild([*flags, *ckpt, "--steps", str(steps), "--seed", str(seed),
                                           "--metrics-jsonl", jsonl], root, f"cli_{name}"), jsonl)
    except BaseException:
        for child, _ in children.values():
            child.kill()
        raise
    return children


def scalar_cli_phase(children, root):
    """(a') once the children exited: each one's launches from its
    ``done:`` line against its pool steps + updates + advantage passes.
    Kills them either way."""
    import os

    from dotaclient_tpu_torch.config import RunConfig

    runs = SCALAR_CLI_RUNS
    try:
        out = {}
        for name, (child, jsonl) in children.items():
            rc, lines, err, wall = child.result()
            if rc != 0:
                raise AssertionError(f"the {name} learner CLI exited {rc}: {err[-2000:]}")
            steps, frames, fps, launched = done_line(lines, f"the {name} learner CLI")
            _, rows = read_record(jsonl)
            last = rows[-1]
            cfg = RunConfig()
            pool_steps = last["actor_env_steps"] / SCALAR_LANES
            updates = steps * cfg.ppo.epochs_per_batch * max(1, cfg.ppo.minibatches)
            passes = last["advantage/passes_total"]
            if not (steps == runs[name][1] and launched == pool_steps + updates + passes
                    and np.isfinite(last["loss"]) and last["health_ok"] == 1.0):
                raise AssertionError(f"the {name} learner CLI: {steps} steps, lstm_seq launched {launched} times "
                                     f"against {pool_steps:.0f} pool steps + {updates} updates + {passes:.0f} passes, "
                                     f"loss {last['loss']}, health_ok {last['health_ok']}")
            out[name] = {"steps": steps, "frames": frames, "frames_per_s": last["frames_per_sec"],
                         "elapsed_s": last["elapsed_sec"], "wall_s": wall, "pool_steps": pool_steps,
                         "lstm_seq_launches": launched, "updates": updates, "advantage_passes": passes,
                         "env_steps": last["actor_env_steps"]}
            log(f"scalar (a'), the learner CLI {' '.join(runs[name][0])}: {steps} steps, {frames} frames, "
                f"{out[name]['frames_per_s']:.0f} frames/s over {last['elapsed_sec']:.1f} s of train, {wall:.1f} s "
                f"with its start; lstm_seq launches {launched} = {pool_steps:.0f} pool steps + {updates} updates + "
                f"{passes:.0f} passes")
    finally:
        for child, _ in children.values():
            child.kill()
    out["ckpt_dir"] = os.path.join(root, "scalar_ckpt")
    return out


def eval_served_phase(ckpt_dir, seed, root, smi=""):
    """(b) ``evaluate_served``: games against the hard bot through a serve
    CLI child on (a')'s checkpoint, in this process's scalar games, every
    request traced: the child with ``--trace-jsonl``, this process's tracer
    at sample 1 around the games, under the sync guard."""
    import os
    import signal

    import torch

    from dotaclient_tpu_torch.league.evaluation import evaluate_served
    from dotaclient_tpu_torch.utils import telemetry, trace_report, tracing
    from dotaclient_tpu_torch.utils.checkpoint import CheckpointManager

    server_log, client_log = os.path.join(root, "serve_eval.jsonl"), os.path.join(root, "eval_client.jsonl")
    serve = ModuleChild("dotaclient_tpu_torch.serve", ["--checkpoint", ckpt_dir, "--serve-listen", "127.0.0.1:0",
                                                       "--trace-jsonl", server_log], root, "serve_eval")
    try:
        deadline = time.perf_counter() + WAIT_S
        while not any(x.startswith("SERVE_LISTENING ") for x in serve.lines()):
            if serve.proc.poll() is not None or time.perf_counter() > deadline:
                raise AssertionError(f"the serve CLI never listened: {serve.stderr()[-2000:]}")
            time.sleep(0.05)
        start_s = time.perf_counter() - serve.t0
        addr = json.loads(next(x for x in serve.lines() if x.startswith("SERVE_LISTENING "))[len("SERVE_LISTENING "):])
        cfg = CheckpointManager(ckpt_dir, registry=telemetry.Registry()).restore_config()
        cfg = dataclasses.replace(cfg, env=dataclasses.replace(cfg.env, max_dota_time=SCALAR_MAX_DOTA_TIME))
        # the tracer reads no device tensor: the guard holds it to that
        tracing.configure(client_log, sample_n=1)
        torch.cuda.set_sync_debug_mode("error")
        t0 = time.perf_counter()
        try:
            out = evaluate_served(cfg, (addr["host"], addr["port"]), opponent="scripted_hard",
                                  n_games=EVAL_SERVED_GAMES, seed=seed)
        finally:
            eval_s = time.perf_counter() - t0
            torch.cuda.set_sync_debug_mode(0)
            tracing.shutdown()
        serve.proc.send_signal(signal.SIGINT)
        rc = serve.wait(WAIT_S)
        if rc != 0:
            raise AssertionError(f"the serve CLI exited {rc}: {serve.stderr()[-2000:]}")
        final = no_codec_fallback(json.loads(serve.lines()[-1]), "the evaluate_served serve CLI")
    finally:
        serve.kill()
    if not (out["episodes"] >= EVAL_SERVED_GAMES and 0.0 <= out["win_rate"] <= 1.0
            and np.isfinite(out["episode_reward_mean"])):
        raise AssertionError(f"evaluate_served: {out}")
    # the CLI's count includes its warm-up dispatch
    launches = final["lstm_seq_launches"] - 1
    if not (launches == final["serve_dispatches_total"] > 0 and final["serve_requests_total"] > 0):
        raise AssertionError(f"the serve CLI's last line {final}: launches = dispatches + its warm-up expected")
    # every request's timeline joined and in hop order; the server logged
    # each one it stamped
    events, skipped = trace_report.load_events([client_log, server_log])
    rtts = [dict(e["hops"]) for e in events if e["event"] == "chunk"]
    served = sum(1 for e in events if e["event"] == "serve_request")
    disordered = [h for h in rtts if not ordered(h, SERVE_HOPS)]
    if disordered or not (len(rtts) == served == final["serve_requests_total"] > 0) or skipped:
        raise AssertionError(f"served requests' traces: {len(rtts)} client timelines ({len(disordered)} out of "
                             f"order: {disordered[:2]}), {served} serve_request events, "
                             f"{final['serve_requests_total']:.0f} requests, {skipped} lines skipped")
    share = float(np.median([(h["reply"] - h["recv"]) / (h["done"] - h["encode"]) for h in rtts]))
    rtt_ms = float(np.median([h["done"] - h["encode"] for h in rtts])) * 1e3
    traces = {"requests": len(rtts), "server_share_p50": share, "rtt_p50_ms": rtt_ms}
    result = {**out, "eval_s": eval_s, "serve_start_s": start_s, "serve": final, "lstm_seq_launches": launches,
              "traces": traces}
    log(f"eval_served (b), traced: {len(rtts)} request timelines joined, every one encode <= recv <= reply <= "
        f"done; median round trip {rtt_ms:.3f} ms, median server share (recv->reply of encode->done) "
        f"{share:.4f}; {smi}")
    log(f"eval_served (b): {out['episodes']:.0f} games against scripted_hard through the serve CLI in {eval_s:.2f} s, "
        f"win rate {out['win_rate']:.3f}, reward mean {out['episode_reward_mean']:.3f}; the server "
        f"{final['serve_requests_total']:.0f} requests in {final['serve_dispatches_total']:.0f} dispatches, p99 "
        f"{final['serve_p99_latency_ms']:.2f} ms, lstm_seq launches {launches} (and the warm-up's); its start "
        f"{start_s:.1f} s")
    return result


def scalar_path_phase(device, seed, socket_frames_per_s, smi=""):
    """Phase 16: BASELINE config 1 in process and through the CLI, the
    served evaluation (traced), and phase 15 (b)'s topology on the shm lane
    (traced)."""
    import tempfile as tf

    t0 = time.perf_counter()
    result = {"grpc": grpc_check()}
    with tf.TemporaryDirectory(prefix="chip_smoke_scalar_") as root:
        # (a')'s children run beside (a)
        children = scalar_cli_start(seed, root)
        try:
            result["scalar"] = scalar_phase(device, seed)
        except BaseException:
            for child, _ in children.values():
                child.kill()
            raise
        result["cli"] = scalar_cli_phase(children, root)
        result["eval_served"] = eval_served_phase(result["cli"]["ckpt_dir"], seed, root, smi)
        result["shm"] = external_phase(device, seed, root, lane="shm", subscriber_ckpt=result["cli"]["ckpt_dir"],
                                       traced=True, smi=smi)
    shm = result["shm"]["frames_per_s_steps_10_to_30"]
    result["shm"]["ratio_to_socket"] = shm / socket_frames_per_s
    result["wall_s"] = time.perf_counter() - t0
    log(f"scalar path and shm lane: phase 16 in {result['wall_s']:.1f} s; the shm learner {shm:.0f} trained "
        f"frames/s between its step-10 and step-30 lines, {result['shm']['ratio_to_socket']:.3f}x phase 15 (b)'s "
        f"socket learner ({socket_frames_per_s:.0f}) in this run")
    return result


# -- phase 17: the transformer and MoE cores ---------------------------------------


TF_WARM, TF_TIMED, TF_PROFILED = 1, 4, 1
MOE_ENVS, MOE_MAX_DOTA_TIME, MOE_WARM, MOE_TIMED, MOE_EXPERTS = 128, 20.0, 1, 2, 4
TF_CLI_STEPS = 4
TF_SERVE_GAMES, TF_SERVE_STEPS = 16, 10


def with_transformer(cfg, moe=0):
    """``cfg`` with the transformer core at the reference's widths (H 128,
    2 layers, 4 heads, a window of 16, bf16 compute, f32 params) and
    ``moe`` Switch experts a layer (capacity factor 2)."""
    return dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, core="transformer", moe_experts=moe))


def carry_layout(carry, lanes, model, what):
    """The carry tree's leaves are (valid [lanes, W], then k and v [lanes,
    W, H] a layer), all f32; returns their shapes."""
    import torch

    from dotaclient_tpu_torch.utils.tree import tree_leaves

    leaves = tree_leaves(carry)
    want = [(lanes, model.context_window)] + [(lanes, model.context_window, model.hidden_dim)] * (2 * model.n_layers)
    got = [tuple(t.shape) for t in leaves]
    if got != want or any(t.dtype != torch.float32 for t in leaves):
        raise AssertionError(f"{what}: carry leaves {got} {[str(t.dtype) for t in leaves]}, expected {want} f32")
    return got


def transformer_league(device, seed, lstm_frames_per_s):
    """(a) BASELINE config 5 at phase 12's league shape with the transformer
    core: warm-up, the timed iterations under the sync guard, a profiled
    window, then a 64-game evaluation."""
    import torch

    from dotaclient_tpu_torch.league import evaluate
    from dotaclient_tpu_torch.ops import lstm
    from dotaclient_tpu_torch.train.learner import Learner
    from dotaclient_tpu_torch.utils import telemetry

    cfg = with_transformer(league_config(seed))
    T = cfg.ppo.rollout_len
    updates = cfg.ppo.steps_per_batch * cfg.steps_per_dispatch
    learner = Learner(cfg, actor="fused", seed=seed, device=device, registry=telemetry.Registry())
    da, pool = learner.device_actor, learner.league
    rec = LeagueRecorder(learner)
    unguarded_end(learner)
    before = {k: v.detach().clone() for k, v in learner.policy.state_dict().items()}
    try:
        torch.cuda.synchronize()
        lstm.lstm_sequence_kernel.launches = 0
        learner.train(TF_WARM * updates)
        torch.cuda.synchronize()
        rec.clear()
        out, wall_s = guarded_train(learner, TF_TIMED * updates)
        launches = lstm.lstm_sequence_kernel.launches
        if launches != 0:
            raise AssertionError(f"lstm_seq launched {launches} times on the transformer path: the core switch "
                                 "did not take")
        metrics = [{k: float(v) for k, v in m.items()} for m in rec.metrics]
        for i, m in enumerate(metrics):
            if not (np.isfinite(m["loss"]) and np.isfinite(m["grad_norm"]) and m["health_ok"] == 1.0):
                raise AssertionError(f"transformer iteration {i}: loss {m['loss']}, grad_norm {m['grad_norm']}, "
                                     f"health_ok {m['health_ok']}")
        frames = TF_TIMED * da.n_lanes * T
        if out["frames_trained"] != frames or len(metrics) != TF_TIMED:
            raise AssertionError(f"{out['frames_trained']} frames in {len(metrics)} iterations, expected {frames}")
        rollout_ms = statistics.mean(a.elapsed_time(b) for a, b, _ in rec.marks)
        update_ms = statistics.mean(b.elapsed_time(c) for _, b, c in rec.marks)
        for snap in pool.snapshots:
            if not all(torch.equal(v, rec.witness[snap.uid][k]) for k, v in snap.params.items()):
                raise AssertionError(f"snapshot {snap.uid} (step {snap.step}) changed after it was taken")
        if len(pool) < 2:
            raise AssertionError(f"{len(pool)} snapshot(s) in the pool")
        chunks, samples = list(rec.chunks), list(rec.samples)
        rec.close()
        profile = profiled(lambda: learner.train(TF_PROFILED * updates))
    finally:
        rec.close()
    layout = carry_layout(chunks[-1]["carry0"], da.n_lanes, cfg.model, "the chunk's carry0")
    carry_layout(da.state.carry, da.n_lanes, cfg.model, "the learner lanes' carry")
    carry_layout(da.state.opp_carry, da.n_opp_lanes, cfg.model, "the opponent lanes' carry")
    moved, _, _ = check_params_moved(before, learner.policy, chunks)
    iters = TF_WARM + TF_TIMED
    if len(samples) != 2 * iters * T:
        raise AssertionError(f"{len(samples)} sample calls in {iters} iterations, expected {2 * iters * T}")
    illegal, n_actions = [0, 0], [0, 0]
    for i, (masks, acts) in enumerate(samples):
        good = actions_legal(masks, acts)
        illegal[i % 2] += int((~good).sum())
        n_actions[i % 2] += good.numel()
    if any(illegal):
        raise AssertionError(f"illegal actions: learner lanes {illegal[0]} of {n_actions[0]}, "
                             f"opponent lanes {illegal[1]} of {n_actions[1]}")
    stats = da.drain_stats()
    frames_per_s = frames / wall_s
    launches_per_iteration = profile["device_events"] / TF_PROFILED
    result = {
        "n_envs": cfg.env.n_envs, "team_size": cfg.env.team_size, "lanes": da.n_lanes,
        "opponent_lanes": da.n_opp_lanes, "rollout_len": T, "hidden_dim": cfg.model.hidden_dim,
        "n_layers": cfg.model.n_layers, "n_heads": cfg.model.n_heads, "context_window": cfg.model.context_window,
        "warm_iterations": TF_WARM, "timed_iterations": TF_TIMED, "frames_trained": frames,
        "frames_per_s": frames_per_s, "iteration_ms": wall_s * 1e3 / TF_TIMED,
        "rollout_ms": rollout_ms, "update_ms": update_ms,
        "ratio_to_lstm_league": frames_per_s / lstm_frames_per_s,
        "launches_per_iteration": launches_per_iteration,
        "device_busy_share": profile["device_busy_share"],
        "lstm_seq_launches": launches, "carry0_leaves": layout,
        "actions_checked": {"learner": n_actions[0], "opponent": n_actions[1]},
        "params_moved": sum(moved.values()), "params": len(moved),
        "episodes_done": stats["episodes_done"], "snapshots": len(pool), "last_metrics": metrics[-1],
        "sync_debug_mode": "error", "profile": {"iterations": TF_PROFILED, **profile},
    }
    log(
        f"transformer league: {TF_TIMED} timed fused iterations x {da.n_lanes} learner lanes (and "
        f"{da.n_opp_lanes} opponent lanes) x {T} steps = {frames} trained frames in {wall_s * 1e3:.1f} ms: "
        f"{frames_per_s:.0f} frames/s, {frames_per_s / lstm_frames_per_s:.3f} of phase 12's LSTM league in this "
        f"run; {result['iteration_ms']:.2f} ms an iteration (rollout {rollout_ms:.2f} ms, update {update_ms:.2f} "
        f"ms between CUDA events); {launches_per_iteration:.0f} kernels and copies an iteration; no host sync "
        f"inside the iterations; loss {metrics[-1]['loss']:.4g}, health_ok 1 in all; {n_actions[0]} learner and "
        f"{n_actions[1]} opponent actions legal; {sum(moved.values())} of {len(moved)} param tensors moved; "
        f"{len(pool)} snapshots, each bitwise as taken; carry0 leaves {layout} f32; lstm_seq launches {launches}"
    )
    log_profile(f"transformer league profile: {TF_PROFILED} iterations", profile)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ev = evaluate(cfg, learner.policy, learner.policy.state_dict(), "scripted_hard", n_games=LEAGUE_EVAL_GAMES,
                  seed=seed, device=device)
    torch.cuda.synchronize()
    eval_s = time.perf_counter() - t0
    if lstm.lstm_sequence_kernel.launches != 0:
        raise AssertionError("lstm_seq launched in the transformer evaluation")
    if not (ev["episodes"] >= LEAGUE_EVAL_GAMES and 0.0 <= ev["win_rate"] <= 1.0):
        raise AssertionError(f"the transformer evaluation: {ev} for {LEAGUE_EVAL_GAMES} games")
    log(f"transformer evaluate vs scripted_hard: {LEAGUE_EVAL_GAMES} games, {ev['episodes']:.0f} episodes, win rate "
        f"{ev['win_rate']:.4f}; {eval_s:.2f} s wall")
    result["eval"] = {**ev, "wall_s": eval_s}
    learner.close()
    return result


def moe_fused(device, seed):
    """(b) The MoE transformer (4 experts a layer) fused at 128 games of 1v1
    against the easy bot, the demo's recipe, cut to 20 s games."""
    import torch

    from dotaclient_tpu_torch.config import RunConfig
    from dotaclient_tpu_torch.ops import lstm
    from dotaclient_tpu_torch.train.learner import Learner
    from dotaclient_tpu_torch.utils import telemetry

    base = RunConfig()
    cfg = with_transformer(dataclasses.replace(
        base, env=dataclasses.replace(base.env, n_envs=MOE_ENVS, opponent="scripted_easy",
                                      max_dota_time=MOE_MAX_DOTA_TIME),
        log_every=10 ** 9, seed=seed), moe=MOE_EXPERTS)
    T = cfg.ppo.rollout_len
    updates = cfg.ppo.steps_per_batch * cfg.steps_per_dispatch
    learner = Learner(cfg, actor="fused", seed=seed, device=device, registry=telemetry.Registry())
    rec = Recorder(learner)
    unguarded_end(learner)
    try:
        torch.cuda.synchronize()
        lstm.lstm_sequence_kernel.launches = 0
        learner.train(MOE_WARM * updates)
        torch.cuda.synchronize()
        rec.clear()
        out, wall_s = guarded_train(learner, MOE_TIMED * updates)
    finally:
        rec.close()
    metrics = [{k: float(v) for k, v in m.items()} for m in rec.metrics]
    for i, m in enumerate(metrics):
        if not (np.isfinite(m["loss"]) and m["health_ok"] == 1.0 and np.isfinite(m["moe_aux"]) and m["moe_aux"] > 0):
            raise AssertionError(f"MoE iteration {i}: loss {m['loss']}, health_ok {m['health_ok']}, "
                                 f"moe_aux {m['moe_aux']}")
    if lstm.lstm_sequence_kernel.launches != 0:
        raise AssertionError("lstm_seq launched on the MoE path")
    illegal, n_actions = check_chunk_actions(rec.chunks)
    if illegal:
        raise AssertionError(f"{illegal} of {n_actions} MoE actions illegal")
    chunk = rec.chunks[-1]
    with torch.no_grad():
        _, _, _, moe = learner.policy.sequence(chunk["obs"], chunk["carry0"], chunk["dones"], return_moe=True)
    dropped = [1.0 - float(frac.sum()) / (frac.shape[0] * frac.shape[1]) for _, frac in moe]
    load = [[float(x) for x in frac.sum(dim=(0, 1)) / (frac.shape[0] * frac.shape[1])] for _, frac in moe]
    frames = MOE_TIMED * learner.device_actor.n_lanes * T
    result = {"n_envs": MOE_ENVS, "experts": MOE_EXPERTS, "capacity_factor": cfg.model.moe_capacity_factor,
              "frames_per_s": frames / wall_s, "iteration_ms": wall_s * 1e3 / MOE_TIMED,
              "moe_aux": [m["moe_aux"] for m in metrics], "dropped_share_by_layer": dropped,
              "expert_load_by_layer": load, "actions_checked": n_actions, "last_metrics": metrics[-1],
              "sync_debug_mode": "error"}
    log(f"MoE: {MOE_TIMED} timed fused iterations x {learner.device_actor.n_lanes} lanes x {T} steps: "
        f"{result['frames_per_s']:.0f} frames/s, {result['iteration_ms']:.2f} ms an iteration, no host sync inside; "
        f"moe_aux {', '.join(f'{a:.4f}' for a in result['moe_aux'])}; tokens dropped at capacity by layer "
        f"{', '.join(f'{d:.4f}' for d in dropped)} (the last chunk's sequence forward, C = ceil(B/E x "
        f"{cfg.model.moe_capacity_factor}) a step); expert load {load}; {n_actions} actions legal")
    learner.close()
    return result


class TransformerCLI:
    """(c) ``python -m dotaclient_tpu_torch.train.learner --core transformer
    --smoke`` as a child writing checkpoints into ``ckpt``, started here and
    read by ``result`` (its exit within CHILD_S, 0 required: its lines and
    wall seconds)."""

    def __init__(self, seed, ckpt):
        self.ckpt = ckpt
        self.child = Child(["dotaclient_tpu_torch.train.learner", "--core", "transformer", "--smoke", "--steps",
                            str(TF_CLI_STEPS), "--checkpoint-dir", ckpt, "--seed", str(seed)])

    def result(self):
        child = self.child
        try:
            rc = child.proc.wait(timeout=CHILD_S)
            child._reader.join(30)
            lines = child.drain()
        except BaseException:
            log("the transformer learner CLI's output so far:\n" + "\n".join(child.drain()[-20:]))
            raise
        finally:
            child.kill()
        if rc != 0:
            raise AssertionError(f"the transformer learner CLI exited {rc}: {lines[-10:]}")
        return lines, time.perf_counter() - child.t0


def transformer_cli_and_serve(device, seed, cli):
    """(c) The buffered learner CLI with ``--core transformer`` (``cli``, a
    started ``TransformerCLI``); (d) a serve CLI child on its checkpoint
    with carry shadow: 16 games x 10 steps over TCP, every action legal,
    and each step's log-prob replayed on the CPU from the carry row the
    server shadowed at the step before."""
    import signal

    import torch

    from dotaclient_tpu_torch.buffer import TrajectoryBuffer
    from dotaclient_tpu_torch.models import distributions as D
    from dotaclient_tpu_torch.serve import load_inference_params, make_inference_policy
    from dotaclient_tpu_torch.utils import telemetry
    from dotaclient_tpu_torch.utils.tree import tree_leaves, tree_unflatten

    lines, cli_s = cli.result()
    steps, frames, fps, launches = done_line(lines, "the transformer learner CLI")
    ckpt = cli.ckpt
    config, params, step = load_inference_params(ckpt)
    if not (steps == TF_CLI_STEPS == step and launches == 0 and config.model.core == "transformer"):
        raise AssertionError(f"the transformer learner CLI: done {steps} steps, {launches} lstm_seq launches, "
                             f"checkpoint step {step}, core {config.model.core}")
    ring = TrajectoryBuffer(config, device=device, registry=telemetry.Registry())
    ring_layout = carry_layout(ring._store["carry0"], config.buffer.capacity_rollouts, config.model, "the ring")
    log(f"transformer learner CLI: done: {steps} steps, {frames} frames, {fps} frames/sec, {launches} lstm_seq "
        f"launches in {cli_s:.1f} s wall; checkpoint step {step}; the ring's carry0 leaves {ring_layout}")

    cfg = dataclasses.replace(config, serve=dataclasses.replace(config.serve, carry_shadow=True))
    child = Child(["dotaclient_tpu_torch.serve", "--checkpoint", ckpt, "--serve-listen", "127.0.0.1:0",
                   "--serve", "carry_shadow=true"])
    try:
        addr, start_s = child.wait_line("SERVE_LISTENING ", "the transformer serve CLI")
        records, _ = lockstep_clients(addr["host"], addr["port"], cfg,
                                      [np.random.default_rng(seed + 4000 + g) for g in range(TF_SERVE_GAMES)],
                                      TF_SERVE_STEPS)
        rc, seen = child.stop(signal.SIGINT)
    except BaseException:
        log("the transformer serve CLI's output so far:\n" + "\n".join(child.drain()[-20:]))
        raise
    finally:
        child.kill()
    if rc != 0:
        raise AssertionError(f"the transformer serve CLI exited {rc}: {seen[-10:]}")
    final = no_codec_fallback(json.loads(seen[-1]), "the transformer serve CLI")
    n = TF_SERVE_GAMES * TF_SERVE_STEPS
    if final["serve_requests_total"] != n or final["lstm_seq_launches"] != 0:
        raise AssertionError(f"the transformer serve CLI's last line {final}: expected {n} requests, 0 launches")
    flat = [rec for game in records for rec in game]
    if not rows_legal([rec[0] for rec in flat], [rec[2] for rec in flat]).all():
        raise AssertionError("an illegal action from the transformer serve CLI")
    names = sorted(flat[0][9])
    if names != [f"c{i}" for i in range(1 + 2 * cfg.model.n_layers)]:
        raise AssertionError(f"shadow rows named {names}")
    # each step on the CPU from the row the server shadowed after the step
    # before (zeros at a reset): the served log-prob, and the next row; and
    # two controls, every step from another game's row and from a zero row
    policy = make_inference_policy(cfg, device="cpu")
    policy.load_state_dict(params)
    tmpl = policy.initial_state(TF_SERVE_GAMES)
    errs, controls, worst_carry = [], {"permuted": 0.0, "zeroed": 0.0}, 0.0
    with torch.no_grad():
        for r in range(TF_SERVE_STEPS):
            rows = [records[g][r] for g in range(TF_SERVE_GAMES)]
            leaves = [torch.stack([torch.zeros(t.shape[1:]) if rows[g][1] else
                                   torch.from_numpy(np.asarray(records[g][r - 1][9][f"c{i}"])).reshape(t.shape[1:])
                                   for g in range(TF_SERVE_GAMES)]) for i, t in enumerate(tree_leaves(tmpl))]
            obs = {k: torch.from_numpy(np.stack([np.asarray(row[0][k]) for row in rows])) for k in rows[0][0]}
            actions = {h: torch.tensor([int(row[2][i]) for row in rows]) for i, h in enumerate(D.HEADS)}
            served = np.asarray([row[3] for row in rows], np.float32)
            logits, _, carry = policy.step(obs, tree_unflatten(tmpl, leaves))
            errs.extend(np.abs(D.log_prob(logits, obs, actions).numpy() - served))
            for i, t in enumerate(tree_leaves(carry)):
                shadow = np.stack([np.asarray(row[9][f"c{i}"]) for row in rows]).reshape(t.shape)
                worst_carry = max(worst_carry, float(np.abs(t.numpy() - shadow).max()))
            for name, fault in (("permuted", [torch.roll(x, 1, 0) for x in leaves]),
                                ("zeroed", [torch.zeros_like(x) for x in leaves])):
                clogits, _, _ = policy.step(obs, tree_unflatten(tmpl, fault))
                controls[name] = max(controls[name],
                                     float(np.abs(D.log_prob(clogits, obs, actions).numpy() - served).max()))
    errs = np.asarray(errs)
    worst_logp, p95 = float(errs.max()), float(np.quantile(errs, 0.95))
    beyond = int((errs > SOCKET_LOGP_ATOL).sum())
    if not (p95 <= SOCKET_LOGP_ATOL and worst_logp <= SERVE_LOGP_ATOL):
        raise AssertionError(f"the CPU replay from the shadowed carry rows: 95th percentile {p95:.3g} (bound "
                             f"{SOCKET_LOGP_ATOL}), largest {worst_logp:.3g} (bound {SERVE_LOGP_ATOL}) from the "
                             "served log-probs")
    if not min(controls.values()) > SERVE_LOGP_ATOL:
        raise AssertionError(f"the replay's controls {controls} do not read above {SERVE_LOGP_ATOL}: the check "
                             "cannot tell a right carry from a wrong one")
    log(f"transformer serve CLI (carry shadow): SERVE_LISTENING after {start_s:.1f} s; {n} requests from "
        f"{TF_SERVE_GAMES} games x {TF_SERVE_STEPS} steps, every action legal, shadow rows {names}; the CPU "
        f"replay from the shadowed rows: 95th percentile {p95:.3g} of the served log-probs (bound "
        f"{SOCKET_LOGP_ATOL}), largest {worst_logp:.3g} (bound {SERVE_LOGP_ATOL}), {beyond} of {n} above "
        f"{SOCKET_LOGP_ATOL}; its next rows within {worst_carry:.3g} of the shadowed ones; controls from another "
        f"game's row {controls['permuted']:.3g}, from a zero row {controls['zeroed']:.3g}; exit 0 on SIGINT; "
        f"lstm_seq launches {final['lstm_seq_launches']}")
    return {"cli": {"steps": steps, "frames": frames, "frames_per_s": fps, "lstm_seq_launches": launches,
                    "wall_s": cli_s, "ring_carry0_leaves": ring_layout},
            "serve": {"requests": n, "start_s": start_s, "logp_max_err": worst_logp, "logp_p95_err": p95,
                      "logp_above_socket_atol": beyond, "carry_max_err": worst_carry, "controls": controls,
                      "shadow_leaves": names, "final": final}}


def transformer_phase(device, seed, lstm_league_frames_per_s):
    """Phase 17: the transformer core at BASELINE config 5's league shape,
    the MoE core fused, the buffered learner CLI and the serve CLI on its
    checkpoint."""
    import torch

    import os

    t0 = time.perf_counter()
    result = {"league": transformer_league(device, seed, lstm_league_frames_per_s)}
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_tf_") as root:
        # the learner CLI child starts (a CUDA context, its imports) while
        # the MoE learner runs here
        cli = TransformerCLI(seed, os.path.join(root, "transformer_ckpt"))
        try:
            result["moe"] = moe_fused(device, seed)
        except BaseException:
            cli.child.kill()
            raise
        torch.cuda.empty_cache()
        result.update(transformer_cli_and_serve(device, seed, cli))
    result["wall_s"] = time.perf_counter() - t0
    log(f"phase 17 (transformer and MoE cores): {result['wall_s']:.1f} s")
    return result


# -- phase 18: the wire (the native codec, the narrow wires) ------------------------------

# (a): passes over the chunks of one pool phase, each codec and wire timed
CODEC_REPS = 2
# (b): phase 15 (b)'s topology on the narrow wires: the learner's steps, and
# the step line at which the actors are stopped (no kill); the steps after
# the stop come from the ring and the flushed chunks
WIRE_STEPS, WIRE_STOP_AT = 24, 20
# (c): the buffered learner's collects on a narrow ring
NARROW_COLLECTS = 2


def codec_phase(device, seed):
    """(a) the chunks a ``VecActorPool`` ships at BASELINE config 2 (64
    self-play games: one chunk a lane after one pool phase), encoded and
    decoded by the native codec and by protobuf, at f32 and on the bf16
    wire, in this process; the rates on the host clock."""
    import torch

    from dotaclient_tpu_torch.actor.vec_runtime import VecActorPool
    from dotaclient_tpu_torch.models.policy import init_params, make_policy
    from dotaclient_tpu_torch.transport import serialize as S
    from dotaclient_tpu_torch.utils import telemetry

    cfg = vec_config(seed)
    policy = make_policy(cfg.model, cfg.obs, cfg.actions, device=device)
    init_params(policy, torch.Generator().manual_seed(seed))
    chunks = []
    pool = VecActorPool(cfg, policy, dict(policy.state_dict()), seed=seed, version=1, rollout_sink=chunks.extend,
                        device=device, registry=telemetry.Registry())
    pool.run(cfg.ppo.rollout_len)
    if len(chunks) < pool.n_lanes:
        raise AssertionError(f"{len(chunks)} chunks from a pool phase of {pool.n_lanes} lanes")
    narrow = S.rollout_wire_kwargs(dataclasses.replace(
        cfg, transport=dataclasses.replace(cfg.transport, rollout_wire_dtype="bfloat16")))
    calls0 = S.codec_calls()
    out = {"chunks": len(chunks)}
    for wire, kw in (("float32", {}), ("bfloat16", narrow)):
        payloads = {}
        for codec, native in (("native", True), ("protobuf", False)):
            t0 = time.perf_counter()
            for _ in range(CODEC_REPS):
                encoded = [S.encode_rollout_bytes(a, **m, native=native, **kw) for m, a in chunks]
            enc_s = (time.perf_counter() - t0) / CODEC_REPS
            payloads[codec] = [bytes(p) for p in encoded]
            nbytes = sum(len(p) for p in payloads[codec])
            t0 = time.perf_counter()
            for _ in range(CODEC_REPS):
                decoded = [S.decode_rollout_bytes(p, native=native) for p in payloads[codec]]
            dec_s = (time.perf_counter() - t0) / CODEC_REPS
            out[f"{wire}/{codec}"] = {
                "encode_payloads_per_s": len(chunks) / enc_s, "encode_mb_per_s": nbytes / enc_s / 1e6,
                "decode_payloads_per_s": len(chunks) / dec_s, "decode_mb_per_s": nbytes / dec_s / 1e6,
                "chunk_bytes": nbytes / len(chunks)}
            if codec == "protobuf":
                proto_decoded = decoded
            else:
                native_decoded = decoded
        # the two codecs agree: native bytes parse to protobuf's message,
        # and each payload decodes to the same arrays either way
        for (m, a), nat, pro in zip(chunks, payloads["native"], payloads["protobuf"]):
            if S.pb.Rollout.FromString(nat) != S.pb.Rollout.FromString(pro):
                raise AssertionError(f"{wire}: native bytes parse to another message than protobuf's")
        for (mn, an), (mp, ap) in zip(native_decoded, proto_decoded):
            fn, fp = S.flatten_tree(an), S.flatten_tree(ap)
            if mn != mp or sorted(fn) != sorted(fp) or not all(
                    (torch.equal(fn[k], fp[k]) if isinstance(fn[k], torch.Tensor) else np.array_equal(fn[k], fp[k]))
                    for k in fn):
                raise AssertionError(f"{wire}: the native and protobuf decodes differ")
        if wire == "bfloat16":
            # the one copy of the bf16 leaves a native decode makes
            leaves = [t for t in S.flatten_tree(native_decoded[0][1]).values() if isinstance(t, torch.Tensor)]
            bits = [S.bf16_tensor_to_bits(t) for t in leaves]
            t0 = time.perf_counter()
            for _ in range(100):
                for b in bits:
                    S.bits_to_bf16_tensor(b)
            out["bf16_copy_us_per_chunk"] = (time.perf_counter() - t0) / 100 * 1e6
            out["bf16_leaves"] = len(leaves)
            out["wire_bytes_ratio"] = native_decoded[0][0]["raw_bytes"] / native_decoded[0][0]["wire_bytes"]
    calls = {k: v - calls0[k] for k, v in S.codec_calls().items()}
    n = len(chunks) * CODEC_REPS * 2
    if calls != {"native_encodes": n, "native_decodes": n, "proto_fallbacks": 0}:
        raise AssertionError(f"the codec's calls {calls}: expected {n} native encodes and decodes, no fallback")
    for wire in ("float32", "bfloat16"):
        nat, pro = out[f"{wire}/native"], out[f"{wire}/protobuf"]
        out[f"{wire}/native_over_protobuf"] = {
            "encode": nat["encode_payloads_per_s"] / pro["encode_payloads_per_s"],
            "decode": nat["decode_payloads_per_s"] / pro["decode_payloads_per_s"]}
    log(f"wire (a): {len(chunks)} chunks of a pool phase at config 2, {CODEC_REPS} passes a codec, host clock: "
        + "; ".join(f"{w} {c}: encode {out[f'{w}/{c}']['encode_payloads_per_s']:.0f} payloads/s "
                    f"{out[f'{w}/{c}']['encode_mb_per_s']:.1f} MB/s, decode {out[f'{w}/{c}']['decode_payloads_per_s']:.0f} "
                    f"payloads/s {out[f'{w}/{c}']['decode_mb_per_s']:.1f} MB/s"
                    for w in ("float32", "bfloat16") for c in ("native", "protobuf"))
        + f"; a chunk {out['float32/native']['chunk_bytes']:.0f} bytes at f32, "
        f"{out['bfloat16/native']['chunk_bytes']:.0f} on the bf16 wire (raw/wire {out['wire_bytes_ratio']:.4f}); "
        f"native over protobuf: f32 encode {out['float32/native_over_protobuf']['encode']:.2f}x decode "
        f"{out['float32/native_over_protobuf']['decode']:.2f}x, bf16 encode "
        f"{out['bfloat16/native_over_protobuf']['encode']:.2f}x decode {out['bfloat16/native_over_protobuf']['decode']:.2f}x; "
        f"the bf16 leaves' one copy ({out['bf16_leaves']} leaves) {out['bf16_copy_us_per_chunk']:.1f} us a chunk; "
        "native and protobuf agree")
    return out


def narrow_ring_bytes(cfg):
    """The resident bytes of a ring of ``cfg``, from its layout on the CPU
    (one row, times the capacity), at the wire dtypes."""
    from dotaclient_tpu_torch.train.ppo import example_batch
    from dotaclient_tpu_torch.transport import serialize as S

    flat = S.flatten_tree(example_batch(cfg, 1, device="cpu"))
    plan = S.rollout_cast_plan({n: S._dtype_name(t) for n, t in flat.items()}, cfg.transport.rollout_wire_dtype,
                               S.rollout_int_bounds(cfg))
    size = {"bfloat16": 2, "int8": 1, "int16": 2}
    return cfg.buffer.capacity_rollouts * sum(t.numel() * size.get(plan.get(n), t.element_size())
                                              for n, t in flat.items())


def narrow_external_phase(seed, root, socket_result, smi=""):
    """(b) phase 15 (b)'s topology over TCP on the narrow wires: the learner
    CLI with ``--rollout-wire-dtype bfloat16 --wire-dtype bfloat16``, 8
    actor CLIs with ``--rollout-wire-dtype bfloat16``, stopped at the
    learner's step-20 line (no kill)."""
    import os
    import signal

    from dotaclient_tpu_torch.config import RunConfig

    connect = f"127.0.0.1:{free_port()}"
    jsonl = os.path.join(root, "external_narrow.jsonl")
    wire = ["--rollout-wire-dtype", "bfloat16"]
    t0 = time.perf_counter()
    deadline = t0 + EXTERNAL_S
    children = []
    try:
        learner = ModuleChild("dotaclient_tpu_torch.train.learner", [
            "--actor", "external", "--transport", "socket", "--listen", connect, "--steps", str(WIRE_STEPS),
            "--seed", str(seed), "--metrics-jsonl", jsonl, "--buffer", f"max_weight_staleness={EXTERNAL_STALENESS}",
            "--fleet-interval", FLEET_INTERVAL, *wire, "--wire-dtype", "bfloat16"], root, "learner_narrow")
        children.append(learner)
        while not any(x.startswith("learner: listening for actors on") for x in learner.lines()):
            if learner.proc.poll() is not None or time.perf_counter() > deadline:
                raise AssertionError(f"the narrow learner never listened: {learner.stderr()[-2000:]}")
            time.sleep(0.05)
        actors = [ModuleChild("dotaclient_tpu_torch.actor", [
            "--connect", connect, "--n-envs", str(VEC_ENVS), "--opponent", "selfplay", "--max-dota-time",
            str(VEC_MAX_DOTA_TIME), "--platform", "cuda", "--seed", str(seed + 1 + i), "--fleet-interval",
            FLEET_INTERVAL, *wire], root, f"actor{i}_narrow") for i in range(EXTERNAL_ACTORS)]
        children += actors
        t_first = wait_step(learner, 10, deadline)
        t_stop = wait_step(learner, WIRE_STOP_AT, deadline)
        for a in actors:
            a.proc.send_signal(signal.SIGTERM)
        closing = []
        for a in actors:
            rc = a.wait(max(1.0, deadline - time.perf_counter()))
            if rc != 0 or "graceful stop: flushed" not in a.stderr():
                raise AssertionError(f"{a.name} exited {rc}: {a.stderr()[-1500:]}")
            closing.append(actor_closing(a))
        rc = learner.wait(max(1.0, deadline - time.perf_counter()))
        if rc != 0:
            raise AssertionError(f"the narrow learner exited {rc}: {learner.stderr()[-3000:]}")
        done = done_fields(learner.lines(), "the narrow external learner")
    finally:
        for c in children:
            c.kill()
    raw, rows = read_record(jsonl)
    last = rows[-1]
    trained = [r for r in rows if "loss" in r]
    cfg = RunConfig()
    narrow_cfg = dataclasses.replace(cfg, transport=dataclasses.replace(cfg.transport, rollout_wire_dtype="bfloat16"))
    want_bytes = narrow_ring_bytes(narrow_cfg)
    updates = done["steps"] * cfg.ppo.epochs_per_batch * max(1, cfg.ppo.minibatches)
    passes = last["advantage/passes_total"]
    bad = {k: last[k] for k in ("buffer/dropped_skew", "buffer/dropped_nonfinite", "buffer/dropped_bounds",
                                "transport/malformed_payloads_total")}
    ratio = last["transport/rollout_compression_ratio"]
    if not (done["steps"] == WIRE_STEPS and done["native_decodes"] > 0 and done["launches"] == updates + passes
            and not any(bad.values()) and ratio > 1.5 and last["buffer/shard_bytes"] == want_bytes
            and trained and np.isfinite(trained[-1]["loss"]) and trained[-1]["health_ok"] == 1.0):
        raise AssertionError(f"the narrow learner: {done}, drops {bad}, compression ratio {ratio}, ring bytes "
                             f"{last['buffer/shard_bytes']} (a narrow ring: {want_bytes}), last metrics "
                             f"{trained[-1] if trained else None}, lstm_seq {done['launches']} against {updates} "
                             f"updates + {passes:.0f} passes")
    for seen, st in closing:
        if not (max(seen) > 0 and st["lstm_seq_launches"] == st["steps"] > 0 and st["native_encodes"] > 0):
            raise AssertionError(f"a narrow actor's closing lines: versions {seen}, stats {st}")
    steady = (WIRE_STOP_AT - 10) * done["frames"] / done["steps"] / (t_stop - t_first)
    window = learner_window(raw, 10, WIRE_STOP_AT, None, None)
    result = {
        "steps": done["steps"], "frames": done["frames"], "frames_per_s": last["frames_per_sec"],
        "frames_per_s_steps_10_to_20": steady, "compression_ratio": ratio,
        "rollout_bytes": last["transport/rollout_bytes_total"],
        "rollout_raw_bytes": last["transport/rollout_raw_bytes_total"],
        "ring_bytes": last["buffer/shard_bytes"], "ring_bytes_f32": socket_result["ring_bytes"],
        "codec": {k: done[k] for k in ("native_decodes", "native_encodes", "proto_fallbacks")},
        "actors_codec": {k: sum(st[k] for _, st in closing) for k in ("native_encodes", "proto_fallbacks")},
        "lstm_seq_launches": done["launches"], "advantage_passes": passes,
        "actors_lstm_seq_launches": sum(st["lstm_seq_launches"] for _, st in closing),
        "last_loss": trained[-1]["loss"], "socket_frames_per_s": socket_result["frames_per_s_steps_10_to_30"],
        "actors_env_steps_per_s": float(np.mean([st["env_steps_per_sec"] for _, st in closing])),
        "window_steps_10_to_20": window, "wall_s": time.perf_counter() - t0,
    }
    log(f"wire (b): phase 15 (b)'s topology on the bf16 wires ({EXTERNAL_ACTORS} actors, no kill, stopped at step "
        f"{WIRE_STOP_AT}): {done['steps']} steps, {result['frames_per_s']:.0f} trained frames/s, {steady:.0f} between "
        f"the step-10 and step-20 lines (phase 15 (b) in this run {result['socket_frames_per_s']:.0f}); "
        f"transport/rollout_compression_ratio {ratio:.4f} ({result['rollout_raw_bytes']:.0f} full-width bytes over "
        f"{result['rollout_bytes']:.0f} on the wire); the ring {result['ring_bytes']:.0f} bytes resident (narrow; "
        f"phase 15 (b)'s f32 ring {result['ring_bytes_f32']:.0f}); the learner's codec {result['codec']}, the actors' "
        f"{result['actors_codec']}; every actor applied bf16 weights frames; loss {result['last_loss']:.4g}, health_ok "
        f"1; lstm_seq {done['launches']} = {updates} updates + {passes:.0f} passes, "
        f"{result['actors_lstm_seq_launches']:.0f} in the actors; the actors' mean "
        f"{result['actors_env_steps_per_s']:.0f} env steps/s; {result['wall_s']:.1f} s; {smi}")
    log(f"wire (b), the learner's steps 10-20 ({window['record_wall_s']:.2f} s by its record): span shares "
        + ", ".join(f"{k} {v:.4f}" for k, v in window["span_shares"].items()) + "; util/phase "
        + ", ".join(f"{k} {v:.4f}" for k, v in window["util_phases"].items()))
    return result


def narrow_buffered_phase(device, seed):
    """(c) the buffered learner on a narrow ring in this process: a few
    collects under the sync guard; a take of the narrow ring against an f32
    ring fed the same chunk widened; a bf16 weights frame through the shm
    slab."""
    import os

    import torch

    from dotaclient_tpu_torch.buffer import TrajectoryBuffer
    from dotaclient_tpu_torch.models.convert import convert, to_flax
    from dotaclient_tpu_torch.ops import lstm
    from dotaclient_tpu_torch.train.learner import Learner
    from dotaclient_tpu_torch.transport import serialize as S
    from dotaclient_tpu_torch.transport.shm_transport import ShmTransport, ShmTransportServer
    from dotaclient_tpu_torch.utils import telemetry
    from dotaclient_tpu_torch.utils.tree import tree_leaves, tree_map

    f32_cfg = buffered_config(seed)
    cfg = dataclasses.replace(f32_cfg, transport=dataclasses.replace(f32_cfg.transport,
                                                                        rollout_wire_dtype="bfloat16"))
    T, B, updates = cfg.ppo.rollout_len, cfg.ppo.batch_rollouts, cfg.ppo.steps_per_batch
    reg = telemetry.Registry()
    learner = Learner(cfg, actor="device", seed=seed, device=device, registry=reg)
    da, buf = learner.device_actor, learner.buffer
    metrics = []
    optimize = learner._optimize

    def recording(batch):
        m = optimize(batch)
        metrics.append(m)
        return m

    learner._optimize = recording
    unguarded_end(learner)
    torch.cuda.synchronize()
    lstm.lstm_sequence_kernel.launches = 0
    _, loop_s = guarded_train(learner, NARROW_COLLECTS * STEPS_PER_COLLECT)
    torch.cuda.synchronize()
    launches = lstm.lstm_sequence_kernel.launches
    passes = reg.snapshot()["advantage/passes_total"]
    batches = NARROW_COLLECTS * da.n_lanes // B
    expected = NARROW_COLLECTS * T + passes + batches * updates
    store = S.flatten_tree(buf._store)
    dtypes = {n: str(store[n].dtype)[6:] for n in ("obs/units", "actions/move_x", "obs/unit_handles",
                                                    "behavior_logp", "carry0/0")}
    if launches != expected or dtypes != {"obs/units": "bfloat16", "actions/move_x": "int8",
                                          "obs/unit_handles": "int16", "behavior_logp": "float32",
                                          "carry0/0": "float32"}:
        raise AssertionError(f"the narrow buffered learner: lstm_seq {launches} (expected {expected:.0f}), the "
                             f"ring's dtypes {dtypes}")
    metrics = [{k: float(v) for k, v in m.items()} for m in metrics]
    if len(metrics) != batches or not all(np.isfinite(m["loss"]) and m["health_ok"] == 1.0 for m in metrics):
        raise AssertionError(f"the narrow buffered learner's {len(metrics)} batches: {metrics[-1:]}")
    # the narrow ring's take against an f32 ring fed the same chunk widened
    chunk, _ = da.collect(learner.policy)
    narrow = TrajectoryBuffer(cfg, device=device, registry=telemetry.Registry())
    wide = TrajectoryBuffer(f32_cfg, device=device, registry=telemetry.Registry())
    narrow.add_device(chunk, 0)
    wide.add_device(tree_map(lambda c, s: c.to(s.dtype), chunk, wide._store), 0)
    start, mid, end = (torch.cuda.Event(enable_timing=True) for _ in range(3))
    start.record()
    got = narrow.take(B)
    mid.record()
    want = wide.take(B)
    end.record()
    torch.cuda.synchronize()
    leaves = list(zip(tree_leaves(got), tree_leaves(want)))
    if not all(g.dtype == w.dtype and torch.equal(g, w) for g, w in leaves):
        raise AssertionError("the narrow ring's take differs from the f32 ring's fed the same rows widened")
    ring_bytes = {"narrow": narrow._tel.snapshot()["buffer/shard_bytes"],
                  "f32": wide._tel.snapshot()["buffer/shard_bytes"]}
    # a bf16 weights frame through the shm slab
    name = f"chip-smoke-wire-{os.getpid()}-{seed}"
    host = {k: v.detach().cpu() for k, v in learner.policy.state_dict().items()}
    frames = {w: S.encode_weights(to_flax(host), learner.state.version, wire_dtype=w)
              for w in ("float32", "bfloat16")}
    server = ShmTransportServer(name=name, slots=1, ring_bytes=1 << 20, weights_bytes=cfg.transport.shm_weights_bytes,
                                registry=telemetry.Registry())
    try:
        actor = ShmTransport(name)
        try:
            server.publish_weights(frames["bfloat16"])
            version, tree = S.decode_weights(actor.latest_weights())
        finally:
            actor.close()
    finally:
        server.close()
        leftovers = shm_leftovers(name)
    got_params = convert(tree)
    rounded = {k: torch.from_numpy(S.bf16_bits_to_f32(S.f32_to_bf16_bits(v.numpy()))) if v.is_floating_point()
               else v for k, v in host.items()}
    if leftovers or version != learner.state.version or not all(
            torch.equal(got_params[k], rounded[k]) for k in host):
        raise AssertionError(f"the bf16 weights frame through the slab: version {version}, leftovers {leftovers}, "
                             f"params equal to the bf16-rounded ones: "
                             f"{sum(torch.equal(got_params[k], rounded[k]) for k in host)} of {len(host)}")
    learner.close()
    result = {
        "collects": NARROW_COLLECTS, "batches": batches, "frames_per_s": batches * B * T / loop_s,
        "lstm_seq_launches": launches, "advantage_passes": passes, "ring_dtypes": dtypes, "ring_bytes": ring_bytes,
        "take_ms": {"narrow": start.elapsed_time(mid), "f32": mid.elapsed_time(end)},
        "weights_frame_bytes": {w: f.ByteSize() for w, f in frames.items()}, "last_loss": metrics[-1]["loss"],
    }
    log(f"wire (c): the buffered learner on a bf16 ring, {NARROW_COLLECTS} collects under the sync guard, {batches} "
        f"batches: {result['frames_per_s']:.0f} trained frames/s, loss {result['last_loss']:.4g}, health_ok 1, "
        f"lstm_seq {launches} = {NARROW_COLLECTS} x {T} + {passes:.0f} + {batches} x {updates}; the ring {dtypes}, "
        f"{ring_bytes['narrow']:.0f} bytes resident against {ring_bytes['f32']:.0f} at f32; take of {B} equal bit for "
        f"bit to the f32 ring's ({result['take_ms']['narrow']:.3f} / {result['take_ms']['f32']:.3f} ms issue to issue); "
        f"a bf16 weights frame ({result['weights_frame_bytes']['bfloat16']} bytes, f32 "
        f"{result['weights_frame_bytes']['float32']}) through the shm slab equal to the params rounded to bf16")
    return result


def wire_phase(device, seed, socket_result, smi=""):
    """Phase 18: the codec in process, the narrow wires across processes,
    the narrow ring in process."""
    t0 = time.perf_counter()
    result = {"codec": codec_phase(device, seed)}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_wire_") as root:
        result["external"] = narrow_external_phase(seed, root, socket_result, smi)
    result["buffered"] = narrow_buffered_phase(device, seed)
    result["wall_s"] = time.perf_counter() - t0
    log(f"phase 18 (the wire): {result['wall_s']:.1f} s")
    return result


# -- phase 19: data-parallel training over torch.distributed ---------------------------

# (a): the learner CLI under torch.distributed.run at world 1 over NCCL, at
# phase 14's traffic (128 games against the easy bot, the default batch of
# 32 chunks), DP_CLI_STEPS steps: a log line at step 10 and the closing one
DP_CLI_STEPS, DP_CLI_S = 12, 300.0
# (b): phase 6's fused traffic (128 games, one update an iteration) at
# world 2 on the one card over gloo (64 games a rank) and at world 1 in
# this process: DP_WARM, then DP_TIMED timed iterations
DP_WARM, DP_TIMED, DP_RANK_S = 1, 4, 600.0
# world 2 against world 1 after the first update (the chunk it trains on is
# bitwise equal): the CPU tests' rule, the loss within DP_RTOL, params within
# DP_RTOL / DP_ATOL but for at most DP_MAX_PAST of the elements (the
# gradient sum is reassociated over the ranks, and a coordinate whose
# gradient is within rounding of 0 may flip its Adam step); grad_norm within
# DP_GRAD_RTOL, two bf16 roundings: at bf16 compute the backward rounds each
# rank's partial gradient to bf16 before the sum, where world 1 rounds the
# whole gradient once (at f32 compute the norms agree to rounding)
DP_RTOL, DP_ATOL, DP_MAX_PAST, DP_GRAD_RTOL = 1e-4, 1e-6, 0.01, 2.0 ** -7


def dp_train(device, seed, timed_psum):
    """Phase 6's fused learner at the world this process is in (a world of
    1 without a process group): its first chunk, its params and metrics
    after the first update, its params after DP_WARM + DP_TIMED iterations
    on the host, the timed loop's frames/s
    (host clock around synchronised loops) and, with ``timed_psum``, the
    host seconds inside the update's all-reduces (synchronised around
    each). Every frame counts the job's lanes."""
    import torch

    from dotaclient_tpu_torch.ops import lstm
    from dotaclient_tpu_torch.train import ppo as pppo
    from dotaclient_tpu_torch.train.learner import Learner
    from dotaclient_tpu_torch.utils import telemetry
    from dotaclient_tpu_torch.utils.tree import tree_map

    cfg = train_config(seed)
    T, updates = cfg.ppo.rollout_len, cfg.ppo.steps_per_batch
    learner = Learner(cfg, actor="fused", seed=seed, device=device, registry=telemetry.Registry())
    actor = learner.device_actor
    first, metrics, spent, loop_s = [], [], [0.0, 0], []
    rollout, fused, psum, loop = actor._rollout_impl, learner.fused_step, pppo.psum, learner._run_mode_loop

    def recording(params, state, opp_params=None, **kw):
        out = rollout(params, state, opp_params, **kw)
        if not first:
            first.append(tree_map(lambda t: t.detach().float().cpu().numpy() if t.is_floating_point()
                                  else t.detach().cpu().numpy(), out[1]))
        return out

    def recorded_fused(state, actor_state, opp_params=None):
        out = fused(state, actor_state, opp_params)
        metrics.append(out[2])
        return out

    def timed(x, group):
        if group is None or not timed_psum:
            return psum(x, group)
        torch.cuda.synchronize()
        t = time.perf_counter()
        y = psum(x, group)
        torch.cuda.synchronize()
        spent[0] += time.perf_counter() - t
        spent[1] += 1
        return y

    def timed_loop(num_steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loop(num_steps)
        torch.cuda.synchronize()
        loop_s.append(time.perf_counter() - t0)

    actor._rollout_impl, learner.fused_step, pppo.psum = recording, recorded_fused, timed
    learner._run_mode_loop = timed_loop
    try:
        torch.cuda.synchronize()
        lstm.lstm_sequence_kernel.launches = 0
        learner.train(updates)
        first_params = host_params(learner)
        first_metrics = {k: float(v) for k, v in metrics[0].items()}
        if DP_WARM > 1:
            learner.train((DP_WARM - 1) * updates)
        spent[:] = [0.0, 0]
        loop_s.clear()
        learner.train(DP_TIMED * updates)
        launches = lstm.lstm_sequence_kernel.launches
    finally:
        pppo.psum = psum
        learner.close()
    iters = DP_WARM + DP_TIMED
    if launches != iters * (T + updates):
        raise AssertionError(f"lstm_seq launched {launches} times in {iters} iterations, "
                             f"expected {iters * (T + updates)}")
    last = {k: float(v) for k, v in metrics[-1].items()}
    if not (np.isfinite(last["loss"]) and last["health_ok"] == 1.0):
        raise AssertionError(f"last iteration: loss {last['loss']}, health_ok {last['health_ok']}")
    frames = DP_TIMED * actor.n_lanes * actor.lane_shards * T
    return {"chunk": first[0], "params": host_params(learner), "first_params": first_params,
            "first_metrics": first_metrics,
            "lanes": actor.n_lanes, "lane_shards": actor.lane_shards, "games": [actor._games.start, actor._games.stop],
            "frames_per_s": frames / sum(loop_s), "loop_s": sum(loop_s), "psum_s": spent[0], "psum_calls": spent[1],
            "lstm_seq_launches": launches, "last_metrics": last, "learning_rate": cfg.ppo.learning_rate,
            "iterations": iters}


def host_params(learner):
    return {k: v.detach().cpu().numpy().copy() for k, v in learner.policy.state_dict().items()}


def dp_params_past(got, want):
    """The CPU tests' rule: the elements of ``got`` past rtol DP_RTOL, atol
    DP_ATOL of ``want``, and all elements."""
    past = sum(int((np.abs(got[k] - w) > DP_ATOL + DP_RTOL * np.abs(w)).sum()) for k, w in want.items())
    return past, sum(w.size for w in want.values())


def dp_rank_work(device, seed):
    """Phase 19 (b)'s work on a rank."""
    return dp_train(device, seed, timed_psum=True)


def dp_rank_main(rank, addr, seed, out, work="dp_rank_work"):
    """One gloo rank of phase 19 (b) or phase 20, spawned: cuda:0 for both
    ranks (NCCL refuses two ranks on one device); ``work(device, seed)``
    (a function of this module, by name) is its result."""
    try:
        import torch

        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        device = torch.device("cuda", 0)
        torch.cuda.set_device(device)
        from dotaclient_tpu_torch.ops import build
        from dotaclient_tpu_torch.parallel import initialize_runtime

        build.kernel_library()   # the parent's build, loaded
        initialize_runtime(addr, 2, rank, backend="gloo", timeout_s=DP_RANK_S)
        out.put((rank, True, globals()[work](device, seed)))
    except BaseException:  # noqa: BLE001 - the parent fails the phase with it
        out.put((rank, False, traceback.format_exc()))
    finally:
        import torch.distributed as dist

        if dist.is_initialized():
            dist.destroy_process_group()


def dp_world2(seed, work="dp_rank_work"):
    """Two ranks spawned to run ``work``; their results in rank order."""
    import multiprocessing as mp
    import queue

    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    addr = f"127.0.0.1:{free_port()}"
    procs = [ctx.Process(target=dp_rank_main, args=(r, addr, seed, out, work), daemon=True) for r in range(2)]
    for p in procs:
        p.start()
    results, end = {}, time.monotonic() + DP_RANK_S
    try:
        while len(results) < 2:
            try:
                rank, ok, value = out.get(timeout=max(1.0, min(10.0, end - time.monotonic())))
            except queue.Empty:
                if time.monotonic() > end:
                    raise AssertionError(f"world 2 ran past {DP_RANK_S:.0f} s (ranks done: {sorted(results)})")
                dead = [r for r, p in enumerate(procs) if p.exitcode not in (None, 0) and r not in results]
                if dead:
                    raise AssertionError(f"rank(s) {dead} died: exit codes {[procs[r].exitcode for r in dead]}")
                continue
            if not ok:
                raise AssertionError(f"rank {rank} failed:\n{value}")
            results[rank] = value
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
    return [results[0], results[1]]


def hold_engine_copies(learner):
    """Make the snapshot engine's copies to the host wait for the returned
    gate (set: open), so that none runs on its thread while the train
    thread holds the sync guard."""
    import threading

    gate = threading.Event()
    gate.set()
    engine = learner._snap_engine
    if engine is not None:
        fetch = engine._fetch

        def held_fetch(copy):
            if not gate.wait(WAIT_S):
                raise AssertionError(f"the snapshot engine's copy was held past {WAIT_S:.0f} s")
            return fetch(copy)

        engine._fetch = held_fetch
    return gate


def dp_guarded_learner(argv):
    """(a)'s rank: the learner CLI's ``main(argv)`` with every ``train``
    call's loop under the sync guard once the learner is built (the
    runtime, the mesh and its probe stay outside it); the end of the call
    runs unguarded (``unguarded_end``) and the snapshot engine's copies
    wait for the guard to lift, as in phase 13."""
    import torch

    from dotaclient_tpu_torch.train import learner as learner_mod

    cls = learner_mod.Learner
    init, train = cls.__init__, cls.train

    def guarded_init(self, *args, **kwargs):
        init(self, *args, **kwargs)
        self._sync_gate = gate = hold_engine_copies(self)
        unguarded_end(self, on_lift=gate.set)

    def guarded(self, *args, **kwargs):
        self._sync_gate.clear()
        torch.cuda.set_sync_debug_mode("error")
        try:
            return train(self, *args, **kwargs)
        finally:
            torch.cuda.set_sync_debug_mode(0)
            self._sync_gate.set()

    cls.__init__, cls.train = guarded_init, guarded
    return learner_mod.main(argv)


def dp_cli_child(seed, root):
    """(a): the learner CLI as ``torch.distributed.run`` launches it, world
    1 over NCCL, its train loop under the sync guard (``dp_guarded_learner``),
    started; ``dp_cli_result`` checks it."""
    import os

    jsonl = os.path.join(root, "dp.jsonl")
    rank = "import sys, chip_smoke; sys.exit(chip_smoke.dp_guarded_learner(sys.argv[1:]))"
    return ModuleChild("torch.distributed.run", [
        "--standalone", "--nproc-per-node", "1", "--no-python", sys.executable, "-c", rank, "--multihost",
        "--mesh", "data_parallel=-1", "--n-envs", str(RECORD_ENVS), "--opponent", "scripted_easy", "--steps",
        str(DP_CLI_STEPS), "--seed", str(seed), "--metrics-jsonl", jsonl], root, "dp_cli"), jsonl


def dp_cli_result(child, jsonl):
    """(a)'s exit 0, its runtime and ``done:`` lines, and its record against
    every learner tier (the multichip one among them)."""
    try:
        rc = child.wait(DP_CLI_S)
        lines = child.lines()
        if rc != 0:
            raise AssertionError(f"the learner under torch.distributed.run exited {rc}: {child.stderr()[-3000:]}")
    finally:
        child.kill()
    up = [ln for ln in lines if ln.startswith("learner: distributed runtime up:")]
    want = ("{'process_index': 0, 'process_count': 1, 'local_devices': 1, 'global_devices': 1} over nccl")
    if len(up) != 1 or not up[0].endswith(want):
        raise AssertionError(f"expected one runtime line ending {want!r}: {up}")
    steps, frames, fps, launches = done_line(lines, "the torch.distributed.run learner")
    if steps != DP_CLI_STEPS or launches <= 0:
        raise AssertionError(f"the torch.distributed.run learner: {steps} steps, {launches} lstm_seq launches")
    from dotaclient_tpu_torch.utils import schema

    raw, scalars = read_record(jsonl)
    errors = schema.validate_lines(raw, schema.LEARNER_TIERS)
    if errors:
        raise AssertionError(f"the torch.distributed.run learner's record: {errors}")
    last = scalars[-1]
    gauges = {k: last[k] for k in schema.MULTICHIP_KEYS}
    if not (gauges["mesh/n_devices"] == gauges["mesh/data_shards"] == gauges["mesh/lane_shards"] == 1.0
            and gauges["learner/psum_ms"] > 0 and gauges["buffer/shard_bytes"] > 0):
        raise AssertionError(f"the torch.distributed.run learner's multichip gauges: {gauges}")
    return {"steps": steps, "frames": frames, "frames_per_s": fps, "lstm_seq_launches": launches,
            "runtime_line": up[0], "multichip": gauges, "record_lines": len(raw), "sync_debug_mode": "error",
            "wall_s": child.wall_s}


def data_parallel_phase(device, seed, smi=""):
    """Phase 19: (a) the CLI under torch.distributed.run over NCCL, beside
    (b) world 2 over gloo on the one card against world 1 in this process."""
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_dp_") as root:
        child, jsonl = dp_cli_child(seed, root)
        try:
            ranks = dp_world2(seed)
            one = dp_train(device, seed, timed_psum=False)
            cli = dp_cli_result(child, jsonl)
        finally:
            child.kill()
    log(f"data parallel (a): torch.distributed.run, world 1 over NCCL: {cli['steps']} steps, "
        f"{cli['frames_per_s']} frames/s, {cli['lstm_seq_launches']} lstm_seq launches, record of "
        f"{cli['record_lines']} lines meets every learner tier, multichip {cli['multichip']}, train loop "
        f"under the sync guard, "
        f"{cli['wall_s']:.1f} s with the launcher, beside (b); {smi}")
    for r, res in enumerate(ranks):
        half = TRAIN_ENVS // 2
        if res["lane_shards"] != 2 or res["lanes"] != one["lanes"] // 2 or res["games"] != [half * r, half * (r + 1)]:
            raise AssertionError(f"rank {r}: {res['lane_shards']} lane shards, {res['lanes']} lanes, "
                                 f"games {res['games']}")
    # the first chunk: the ranks' shards, concatenated, bit for bit world 1's
    from dotaclient_tpu_torch.utils.tree import tree_leaves, tree_map

    joined = tree_map(lambda a, b: np.concatenate([a, b]), ranks[0]["chunk"], ranks[1]["chunk"])
    chunk_diff = [float(np.abs(a.astype(np.float64) - b.astype(np.float64)).max())
                  for a, b in zip(tree_leaves(joined), tree_leaves(one["chunk"]))]
    chunk_bitwise = all(np.array_equal(a, b) for a, b in zip(tree_leaves(joined), tree_leaves(one["chunk"])))
    if not chunk_bitwise:
        raise AssertionError(f"the first chunk at world 2 differs from world 1's: max abs diff a leaf {chunk_diff}")
    # the ranks' params equal bit for bit, after the first update and the last
    names = list(one["params"])
    ranks_equal = all(np.array_equal(ranks[0][w][k], ranks[1][w][k]) for w in ("first_params", "params")
                      for k in names)
    if not ranks_equal:
        raise AssertionError("the two ranks' params differ")
    # the first update against world 1's, by the CPU tests' rule
    first_rel = {k: abs(ranks[0]["first_metrics"][k] - one["first_metrics"][k]) / abs(one["first_metrics"][k])
                 for k in ("loss", "grad_norm")}
    if not (first_rel["loss"] <= DP_RTOL and first_rel["grad_norm"] <= DP_GRAD_RTOL):
        raise AssertionError(f"world 2's first update's metrics differ from world 1's: relative {first_rel}, "
                             f"world 2 {ranks[0]['first_metrics']}, world 1 {one['first_metrics']}")
    past, total = dp_params_past(ranks[0]["first_params"], one["first_params"])
    if past > DP_MAX_PAST * total:
        raise AssertionError(f"world 2's params after the first update: {past} of {total} elements past "
                             f"rtol {DP_RTOL} of world 1's (at most {DP_MAX_PAST} of them may be)")
    # after every iteration: logged, not held (two Adam trajectories drift
    # apart by about lr a step once a coordinate's step has flipped)
    atol = 2 * one["learning_rate"] * one["iterations"]
    diffs = np.concatenate([np.abs(ranks[0]["params"][k] - one["params"][k]).ravel() for k in names])
    result = {
        "cli": cli,
        "world2": {k: v for k, v in ranks[0].items() if k not in ("chunk", "params", "first_params")},
        "world2_rank1": {k: v for k, v in ranks[1].items() if k not in ("chunk", "params", "first_params")},
        "world1": {k: v for k, v in one.items() if k not in ("chunk", "params", "first_params")},
        "chunk_bitwise": chunk_bitwise, "ranks_params_bitwise": ranks_equal,
        "first_update_metrics_rel_diff_vs_world1": first_rel,
        "first_update_params_past_vs_world1": past, "params_elements": total,
        "params_max_abs_diff_vs_world1": float(diffs.max()), "params_two_lr_steps": atol,
        "params_bitwise_share_vs_world1": float((diffs == 0).mean()),
        "psum_share_of_loop": ranks[0]["psum_s"] / ranks[0]["loop_s"],
        "lstm_seq_launches": {"cli_world1": cli["lstm_seq_launches"], "world1": one["lstm_seq_launches"],
                              "world2_rank0": ranks[0]["lstm_seq_launches"],
                              "world2_rank1": ranks[1]["lstm_seq_launches"]},
    }
    result["wall_s"] = time.perf_counter() - t0
    # (b)'s rates are read beside (a)'s child, world 1's perhaps after it
    # exited: correctness is held, the rates are logged for the record only
    log(f"data parallel (b), beside (a)'s child: world 2 over gloo on one card ({ranks[0]['lanes']} lanes a rank): "
        f"{ranks[0]['frames_per_s']:.0f} frames/s (the job's), the update's all-reduces "
        f"{result['psum_share_of_loop']:.3f} of the timed loop ({ranks[0]['psum_calls']} calls, "
        f"{ranks[0]['psum_s'] * 1e3:.1f} ms); world 1 in process {one['frames_per_s']:.0f} frames/s; first chunk "
        f"bitwise; the ranks' params bitwise equal; the first update vs world 1: loss and grad_norm relative "
        f"{first_rel} (tolerances {DP_RTOL}, {DP_GRAD_RTOL}), params {past} of {total} elements past rtol {DP_RTOL}; after {one['iterations']} "
        f"iterations (logged only): max abs diff {result['params_max_abs_diff_vs_world1']:.3g} (2 x lr x "
        f"iterations {atol:.3g}), {result['params_bitwise_share_vs_world1']:.4f} of elements bitwise; "
        f"lstm_seq launches "
        f"{result['lstm_seq_launches']}; two ranks on one card say nothing of scaling; {smi}")
    log(f"phase 19 (data parallel): {result['wall_s']:.1f} s")
    return result


# phase 20: the rest of multi-GPU, each part a world of 2 over gloo on the one
# card against world 1 in this process. (a) the external learner: the
# mg_versions() chunks from the seed into a ring of MG_EXT_CAPACITY, MG_EXT_STEPS
# updates; the vec learner MG_VEC_STEPS updates; (b) the
# MoE transformer fused at MG_MOE_ENVS games with capacity factor MG_MOE_CF
# (tokens drop); (c) LSTM(128) fused at model 2, MG_TP_ITERS iterations,
# held to the reference's tp2 tolerance (tests/test_parallel.py)
MG_EXT_CAPACITY, MG_EXT_STEPS, MG_VEC_STEPS = 64, 3, 4
MG_MOE_ENVS, MG_MOE_CF, MG_TP_ITERS = 64, 0.5, 2
TP_RTOL, TP_ATOL = 2e-4, 2e-5


def mg_external_config(seed):
    """The default learner with a ring of MG_EXT_CAPACITY chunks (min_fill
    one batch of 32) and a staleness limit of 1 optimizer step."""
    from dotaclient_tpu_torch.config import RunConfig

    cfg = RunConfig()
    return dataclasses.replace(
        cfg, buffer=dataclasses.replace(cfg.buffer, capacity_rollouts=MG_EXT_CAPACITY, min_fill=32,
                                        max_weight_staleness=1),
        log_every=10 ** 9, seed=seed)


def mg_versions():
    """The chunks' model versions, in publish order. The first ingest (at
    version 0) takes 64; the prefetch at version 1 takes the next 64 into 32
    free slots (32 evictions); chunk 100 (version 0) is admitted then and
    stale at the third take (version 2), whose batch the last 32 fill."""
    versions = [i % 2 for i in range(64)] + [1] * 64 + [2] * 32
    versions[100] = 0
    return versions


def mg_blobs(cfg, seed):
    """The chunks as wire bytes: obs features, actions, log-probs, rewards,
    dones and carries drawn with numpy from the seed (all-legal masks)."""
    from dotaclient_tpu_torch.train.ppo import example_batch
    from dotaclient_tpu_torch.transport import serialize as S
    from dotaclient_tpu_torch.utils.tree import tree_map

    rng = np.random.default_rng(seed + 20)
    T = cfg.ppo.rollout_len
    tmpl = tree_map(lambda t: t[0].numpy(), example_batch(cfg, 1, device="cpu"))
    blobs = []
    for i, v in enumerate(mg_versions()):
        row = tree_map(lambda a: a.copy(), tmpl)
        for k in ("units", "globals"):
            row["obs"][k] = rng.standard_normal(row["obs"][k].shape).astype(np.float32)
        row["actions"] = {h: rng.integers(0, n, size=(T,)).astype(np.int32) for h, n in cfg.actions.head_sizes.items()}
        row["behavior_logp"] = (rng.standard_normal(T) * 0.3 - 1.0).astype(np.float32)
        row["rewards"] = rng.standard_normal(T).astype(np.float32)
        row["dones"] = (rng.random(T) < 0.1).astype(np.float32)
        row["carry0"] = tree_map(lambda a: (rng.standard_normal(a.shape) * 0.5).astype(np.float32), row["carry0"])
        blobs.append(bytes(S.encode_rollout_bytes(row, v, i, i, T, 0.0)))
    return blobs


def lift_cuda_collectives(counts):
    """Lift the sync guard around each all-reduce and broadcast of a CUDA
    tensor (gloo stages it through the host), counted in
    ``counts["collectives"]``; returns the undo."""
    import torch.distributed as dist

    saved = dist.all_reduce, dist.broadcast

    def wrap(fn):
        guarded = lifted(fn, counted(counts, "collectives"))

        def call(tensor, *args, **kwargs):
            return (guarded if tensor.is_cuda else fn)(tensor, *args, **kwargs)
        return call

    dist.all_reduce, dist.broadcast = wrap(saved[0]), wrap(saved[1])

    def undo():
        dist.all_reduce, dist.broadcast = saved
    return undo


def host_tree(tree):
    from dotaclient_tpu_torch.utils.tree import tree_map

    return tree_map(lambda t: t.detach().float().cpu().numpy() if t.is_floating_point() else t.detach().cpu().numpy(),
                    tree)


def mg_external(device, seed):
    """(a) the external learner at the world this process is in, fed
    ``mg_blobs`` through rank 0's in-process transport, its loop under the
    sync guard lifted at the named sites: each all-reduce or broadcast of a
    CUDA tensor (gloo's, through the host) and each cross-shard row move of
    the ring's door (``TrajectoryBuffer._move_rows``)."""
    import torch
    import torch.distributed as dist

    from dotaclient_tpu_torch.ops import lstm
    from dotaclient_tpu_torch.protos import dota_pb2 as pb
    from dotaclient_tpu_torch.train.learner import Learner
    from dotaclient_tpu_torch.transport.queues import InProcTransport
    from dotaclient_tpu_torch.utils import telemetry
    from dotaclient_tpu_torch.utils.tree import tree_map

    cfg = mg_external_config(seed)
    transport = None
    if not dist.is_initialized() or dist.get_rank() == 0:
        transport = InProcTransport(registry=telemetry.Registry())
        for blob in mg_blobs(cfg, seed):
            transport.publish_rollout(pb.Rollout.FromString(blob))
    reg = telemetry.Registry()
    learner = Learner(cfg, actor="external", seed=seed, device=device, registry=reg, transport=transport)
    ring = learner.buffer
    batches, metrics, counts = [], [], {"collectives": 0, "moves": 0}
    take, step = ring.take, learner.train_step

    def taking(*args, **kwargs):
        got = take(*args, **kwargs)
        if got is not None:
            batches.append(tree_map(lambda t: t.clone(), got[0] if isinstance(got, tuple) else got))
        return got

    def stepping(state, batch):
        state, m = step(state, batch)
        metrics.append(m)
        if len(metrics) == 1:
            first.update({k: v.detach().clone() for k, v in learner.policy.state_dict().items()})
        return state, m

    first = {}
    ring.take, learner.train_step = taking, stepping
    ring._move_rows = lifted(ring._move_rows, counted(counts, "moves"))
    gate = hold_engine_copies(learner)
    unguarded_end(learner, on_lift=gate.set)
    undo = lift_cuda_collectives(counts)
    try:
        torch.cuda.synchronize()
        launches0 = lstm.lstm_sequence_kernel.launches
        gate.clear()
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = learner.train(MG_EXT_STEPS, refresh_every=0)
        finally:
            torch.cuda.set_sync_debug_mode(0)
            gate.set()
        torch.cuda.synchronize()
        launches = lstm.lstm_sequence_kernel.launches - launches0
    finally:
        undo()
    result = {"batches": [host_tree(b) for b in batches], "first_metrics": {k: float(v) for k, v in metrics[0].items()},
              "first_params": {k: v.cpu().numpy() for k, v in first.items()}, "params": host_params(learner), "counters": ring.metrics(), "rows_moved": ring.rows_moved,
              "shard_bytes": reg.snapshot()["buffer/shard_bytes"], "lstm_seq_launches": launches,
              "guard_lifted": counts, "steps": out["optimizer_steps"], "updates": len(metrics),
              "learning_rate": cfg.ppo.learning_rate}
    learner.close()
    return result


def mg_vec(device, seed):
    """(a) the vec learner at this world: rank 0 runs the pool."""
    import torch

    from dotaclient_tpu_torch.ops import lstm
    from dotaclient_tpu_torch.train.learner import Learner
    from dotaclient_tpu_torch.utils import telemetry

    cfg = vec_config(seed)
    learner = Learner(cfg, actor="vec", seed=seed, device=device, registry=telemetry.Registry())
    metrics, step = [], learner.train_step

    def stepping(state, batch):
        state, m = step(state, batch)
        metrics.append(m)
        return state, m

    learner.train_step = stepping
    torch.cuda.synchronize()
    launches0 = lstm.lstm_sequence_kernel.launches
    learner.train(MG_VEC_STEPS)
    torch.cuda.synchronize()
    pool = learner.host_pool
    result = {"lstm_seq_launches": lstm.lstm_sequence_kernel.launches - launches0,
              "pool_steps": pool.steps if pool is not None else 0, "updates": len(metrics),
              "losses": [float(m["loss"]) for m in metrics], "params": host_params(learner),
              "counters": learner.buffer.metrics()}
    learner.close()
    return result


def mg_moe_config(seed):
    from dotaclient_tpu_torch.config import RunConfig

    base = RunConfig()
    cfg = with_transformer(dataclasses.replace(
        base, env=dataclasses.replace(base.env, n_envs=MG_MOE_ENVS, opponent="scripted_easy",
                                      max_dota_time=MOE_MAX_DOTA_TIME),
        log_every=10 ** 9, seed=seed), moe=MOE_EXPERTS)
    return dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, moe_capacity_factor=MG_MOE_CF))


def mg_tp_config(seed, model_parallel):
    from dotaclient_tpu_torch.config import MeshConfig

    return dataclasses.replace(train_config(seed), mesh=MeshConfig(data_parallel=1, model_parallel=model_parallel))


def mg_fused(device, seed, cfg, iters, count_moe=False):
    """A fused learner at this world: its first chunk, its metrics and
    params after the first iteration, its params after ``iters``, its
    tensor-parallel layout, and (``count_moe``) each MoE layer's kept and
    routed tokens an expert over the first iteration (this rank's
    tokens)."""
    import torch

    from dotaclient_tpu_torch.models.moe import MoEMLP
    from dotaclient_tpu_torch.ops import lstm
    from dotaclient_tpu_torch.train.learner import Learner
    from dotaclient_tpu_torch.utils import telemetry

    learner = Learner(cfg, actor="fused", seed=seed, device=device, registry=telemetry.Registry())
    actor = learner.device_actor
    rollout, fused, forward = actor._rollout_impl, learner.fused_step, MoEMLP.forward
    first, metrics, tallies, counting = [], [], {}, [count_moe]
    layers = [m for m in learner.policy.modules() if isinstance(m, MoEMLP)]

    def recording(params, state, opp_params=None, **kw):
        out = rollout(params, state, opp_params, **kw)
        if not first:
            first.append(host_tree(out[1]))
        return out

    def recorded(state, actor_state, opp_params=None):
        out = fused(state, actor_state, opp_params)
        metrics.append(out[2])
        counting[0] = False
        return out

    def tallying(self, x, group=None):
        y, (probs, frac) = forward(self, x, group)
        if counting[0] and self in layers:
            E = probs.shape[-1]
            routed = (probs.argmax(dim=-1)[:, None] == torch.arange(E, device=x.device)).float().sum(dim=0)
            i = layers.index(self)
            tallies[i] = tallies.get(i, 0) + torch.stack([frac.sum(dim=0), routed])
        return y, (probs, frac)

    actor._rollout_impl, learner.fused_step, MoEMLP.forward = recording, recorded, tallying
    updates = cfg.ppo.steps_per_batch
    try:
        torch.cuda.synchronize()
        launches0 = lstm.lstm_sequence_kernel.launches
        learner.train(updates)
        first_params = host_params(learner)
        if iters > 1:
            learner.train((iters - 1) * updates)
        torch.cuda.synchronize()
        launches = lstm.lstm_sequence_kernel.launches - launches0
    finally:
        MoEMLP.forward = forward
    layout = {}
    if learner.state.shards is not None:
        s = learner.state.shards
        layout = {name: {"master": list(m.shape), "whole": list(q.shape), "dim": d}
                  for (name, q, d), m in zip(s.named, s.masters)}
    result = {"chunk": first[0], "first_metrics": {k: float(v) for k, v in metrics[0].items()},
              "last_metrics": {k: float(v) for k, v in metrics[-1].items()}, "first_params": first_params,
              "params": host_params(learner), "lstm_seq_launches": launches, "iterations": iters,
              "lanes": actor.n_lanes, "lane_shards": actor.lane_shards, "layout": layout,
              "moe_counts": {i: t.cpu().numpy().astype(np.int64).tolist() for i, t in sorted(tallies.items())},
              "rollout_len": cfg.ppo.rollout_len, "updates": updates, "learning_rate": cfg.ppo.learning_rate}
    learner.close()
    return result


def mg_moe(device, seed):
    """(b) the MoE fused learner with cuBLAS's reduced-precision bf16
    reductions off: with them on (PyTorch's default) a bf16 GEMM's split of
    its reduction may change with the batch's rows, so a transformer's
    rollout at 32 lanes a rank differs from world 1's at 64 in the last
    bits, and its sampled actions with them (measured on an H100); with
    them off the rollout does not depend on the world size."""
    import torch

    matmul = torch.backends.cuda.matmul
    reduced = matmul.allow_bf16_reduced_precision_reduction
    matmul.allow_bf16_reduced_precision_reduction = False
    try:
        return mg_fused(device, seed, mg_moe_config(seed), 1, count_moe=True)
    finally:
        matmul.allow_bf16_reduced_precision_reduction = reduced


def mg_rank_work(device, seed):
    """Phase 20's parts on a rank of the world of 2."""
    return {"external": mg_external(device, seed), "vec": mg_vec(device, seed), "moe": mg_moe(device, seed),
            "tp": mg_fused(device, seed, mg_tp_config(seed, 2), MG_TP_ITERS)}


def tree_bitwise(a, b):
    from dotaclient_tpu_torch.utils.tree import tree_leaves

    return all(np.array_equal(x, y) for x, y in zip(tree_leaves(a), tree_leaves(b)))


def joined(a, b):
    from dotaclient_tpu_torch.utils.tree import tree_map

    return tree_map(lambda x, y: np.concatenate([x, y]), a, b)


def first_update_vs_world1(got, one, what, grad_rtol=DP_GRAD_RTOL, keys=("loss", "grad_norm")):
    """19 (b)'s rule on the first update: the loss within DP_RTOL,
    ``grad_norm`` within ``grad_rtol``, at most DP_MAX_PAST of the params'
    elements past DP_RTOL. Returns the relative differences and the count."""
    rel = {k: abs(got["first_metrics"][k] - one["first_metrics"][k]) / abs(one["first_metrics"][k]) for k in keys}
    tol = {"grad_norm": grad_rtol}
    bad = {k: v for k, v in rel.items() if v > tol.get(k, DP_RTOL)}
    if bad:
        raise AssertionError(f"{what}: the first update's metrics differ from world 1's: relative {rel}")
    past, total = dp_params_past(got["first_params"], one["first_params"])
    if past > DP_MAX_PAST * total:
        raise AssertionError(f"{what}: {past} of {total} param elements past rtol {DP_RTOL} of world 1's")
    return rel, past


def multigpu_rest_phase(device, seed, smi=""):
    """Phase 20: (a) the host-fed modes, (b) the MoE core at data 2 and (c)
    tensor parallelism at model 2, each a world of 2 over gloo on the one
    card against world 1 in this process."""
    t0 = time.perf_counter()
    ranks = dp_world2(seed, work="mg_rank_work")
    world_s = time.perf_counter() - t0
    one = {"external": mg_external(device, seed), "moe": mg_moe(device, seed),
           "tp": mg_fused(device, seed, mg_tp_config(seed, 1), MG_TP_ITERS)}
    out = {"world2_s": world_s}
    # (a) external: world 1's batches, books and first update, half the ring
    e0, e1, e = ranks[0]["external"], ranks[1]["external"], one["external"]
    if not (len(e0["batches"]) == len(e1["batches"]) == len(e["batches"]) == MG_EXT_STEPS):
        raise AssertionError(f"external: batches {len(e0['batches'])}, {len(e1['batches'])}, world 1 "
                             f"{len(e['batches'])}")
    for i, (a, b, w) in enumerate(zip(e0["batches"], e1["batches"], e["batches"])):
        if not tree_bitwise(joined(a, b), w):
            raise AssertionError(f"external: batch {i}, the ranks' shares joined, differs from world 1's")
    c = e["counters"]
    if e0["counters"] != c or not (c["buffer_dropped_stale"] >= 1 and c["buffer_dropped_overflow"] >= 1):
        raise AssertionError(f"external: rank 0's books {e0['counters']}, world 1's {c}")
    if not (e0["shard_bytes"] == e1["shard_bytes"] == e["shard_bytes"] / 2):
        raise AssertionError(f"external: shard bytes {e0['shard_bytes']}, {e1['shard_bytes']}, world 1 "
                             f"{e['shard_bytes']}")
    if not all(np.array_equal(e0["params"][k], e1["params"][k]) for k in e["params"]):
        raise AssertionError("external: the ranks' params differ")
    ext_rel, ext_past = first_update_vs_world1(e0, e, "external")
    for r, res in ((0, e0), (1, e1), ("world 1", e)):
        if res["lstm_seq_launches"] != res["updates"] or res["updates"] != MG_EXT_STEPS:
            raise AssertionError(f"external {r}: {res['lstm_seq_launches']} lstm_seq launches, {res['updates']} "
                                 f"updates")
    if e0["rows_moved"] != e1["rows_moved"] or e0["rows_moved"] < 1:
        raise AssertionError(f"external: rows moved {e0['rows_moved']}, {e1['rows_moved']}")
    out["external"] = {"counters": c, "rows_moved": e0["rows_moved"], "shard_bytes": [e0["shard_bytes"],
                                                                                      e["shard_bytes"]],
                       "first_update_rel_diff": ext_rel, "params_past": ext_past,
                       "guard_lifted_rank0": e0["guard_lifted"], "guard_lifted_rank1": e1["guard_lifted"],
                       "guard_lifted_world1": e["guard_lifted"], "batches_bitwise": MG_EXT_STEPS}
    # (a) vec: rank 0's pool and updates, rank 1's updates alone
    v0, v1 = ranks[0]["vec"], ranks[1]["vec"]
    if not (v0["pool_steps"] > 0 and v1["pool_steps"] == 0
            and v0["lstm_seq_launches"] == v0["pool_steps"] + v0["updates"]
            and v1["lstm_seq_launches"] == v1["updates"] == v0["updates"] == MG_VEC_STEPS):
        raise AssertionError(f"vec: rank 0 {v0['pool_steps']} pool steps, {v0['updates']} updates, "
                             f"{v0['lstm_seq_launches']} launches; rank 1 {v1['pool_steps']}, {v1['updates']}, "
                             f"{v1['lstm_seq_launches']}")
    if not (all(np.isfinite(v0["losses"])) and all(np.array_equal(v0["params"][k], v1["params"][k])
                                                  for k in v0["params"])):
        raise AssertionError(f"vec: losses {v0['losses']}, or the ranks' params differ")
    out["vec"] = {k: [v0[k], v1[k]] for k in ("pool_steps", "updates", "lstm_seq_launches")}
    # (b) MoE at data 2: the chunk, the drops, the first update
    m0, m1, m = ranks[0]["moe"], ranks[1]["moe"], one["moe"]
    if not tree_bitwise(joined(m0["chunk"], m1["chunk"]), m["chunk"]):
        raise AssertionError("MoE: the first chunk at world 2 differs from world 1's")
    counts = {i: (np.array(m0["moe_counts"][i]) + np.array(m1["moe_counts"][i])).tolist() for i in m["moe_counts"]}
    if counts != m["moe_counts"]:
        raise AssertionError(f"MoE: kept and routed tokens an expert {counts}, world 1's {m['moe_counts']}")
    dropped = {i: int(np.sum(np.array(c[1]) - np.array(c[0]))) for i, c in m["moe_counts"].items()}
    if not all(d > 0 for d in dropped.values()):
        raise AssertionError(f"MoE: no token dropped at capacity factor {MG_MOE_CF}: {dropped}")
    moe_rel, moe_past = first_update_vs_world1(m0, m, "MoE", keys=("loss", "grad_norm", "moe_aux"))
    if moe_rel["moe_aux"] > 1e-4:
        raise AssertionError(f"MoE: moe_aux relative {moe_rel['moe_aux']}")
    if not all(np.array_equal(m0["params"][k], m1["params"][k]) for k in m["params"]):
        raise AssertionError("MoE: the ranks' params differ")
    if m0["lstm_seq_launches"] or m1["lstm_seq_launches"] or m["lstm_seq_launches"]:
        raise AssertionError("MoE: lstm_seq launched on the transformer path")
    out["moe"] = {"counts_kept_routed": m["moe_counts"], "dropped": dropped, "first_update_rel_diff": moe_rel,
                  "params_past": moe_past, "moe_aux": m0["first_metrics"]["moe_aux"], "chunk_bitwise": True,
                  "bf16_reduced_precision_reductions": False}
    # (c) LSTM(128) at model 2: the cut, the gather, the updates
    t0_, t1_, t = ranks[0]["tp"], ranks[1]["tp"], one["tp"]
    for r, res in ((0, t0_), (1, t1_)):
        trunk = res["layout"].get("trunk_proj.weight")
        if not trunk or trunk["dim"] != 0 or trunk["master"] != [trunk["whole"][0] // 2, trunk["whole"][1]]:
            raise AssertionError(f"TP rank {r}: trunk_proj's stored shard {trunk}")
        want = MG_TP_ITERS * (res["rollout_len"] + res["updates"])
        if res["lstm_seq_launches"] != want:
            raise AssertionError(f"TP rank {r}: {res['lstm_seq_launches']} lstm_seq launches, expected {want}")
    if not all(np.array_equal(t0_[w][k], t1_[w][k]) for w in ("first_params", "params") for k in t["params"]):
        raise AssertionError("TP: the ranks' gathered params differ")
    tp_rel = {k: abs(t0_["first_metrics"][k] - t["first_metrics"][k]) / abs(t["first_metrics"][k])
              for k in ("loss", "grad_norm")}
    if max(tp_rel.values()) > DP_RTOL:
        raise AssertionError(f"TP: the first update against world 1's: relative {tp_rel}")
    worst = max(float(np.max(np.abs(t0_["params"][k] - w) - (TP_ATOL + TP_RTOL * np.abs(w))))
                for k, w in t["params"].items())
    if worst > 0:
        raise AssertionError(f"TP: params after {MG_TP_ITERS} iterations past rtol {TP_RTOL}, atol {TP_ATOL} of "
                             f"world 1's by {worst}")
    cut = sum(1 for v in t0_["layout"].values() if v["dim"] is not None)
    out["tp"] = {"first_update_rel_diff": tp_rel, "params_worst_excess": worst, "cut_tensors": cut,
                 "tensors": len(t0_["layout"]), "trunk_master": t0_["layout"]["trunk_proj.weight"]["master"]}
    out["lstm_seq_launches"] = {
        "external_world1": e["lstm_seq_launches"], "external_rank0": e0["lstm_seq_launches"],
        "external_rank1": e1["lstm_seq_launches"], "vec_rank0": v0["lstm_seq_launches"],
        "vec_rank1": v1["lstm_seq_launches"], "tp_world1": t["lstm_seq_launches"],
        "tp_rank0": t0_["lstm_seq_launches"], "tp_rank1": t1_["lstm_seq_launches"]}
    out["wall_s"] = time.perf_counter() - t0
    log(f"multi-GPU (a): external at world 2 over gloo: {MG_EXT_STEPS} batches bitwise world 1's, books {c}, "
        f"{e0['rows_moved']} rows crossed shards, shard bytes {e0['shard_bytes']:.0f} (world 1 "
        f"{e['shard_bytes']:.0f}), first update vs world 1 {ext_rel}, params past {ext_past}; the loop under the "
        f"sync guard, lifted at gloo's CUDA collectives and the door's row moves {e0['guard_lifted']} / "
        f"{e1['guard_lifted']}; vec: rank 0 {v0['pool_steps']} pool steps + {v0['updates']} updates = "
        f"{v0['lstm_seq_launches']} lstm_seq launches, rank 1 {v1['lstm_seq_launches']}; {smi}")
    log(f"multi-GPU (b): MoE at data 2 (cuBLAS's reduced-precision bf16 reductions off): first chunk bitwise, "
        f"kept/routed an expert {m['moe_counts']} (dropped "
        f"{dropped}) equal to world 1's, first update vs world 1 {moe_rel}, params past {moe_past}; {smi}")
    log(f"multi-GPU (c): LSTM(128) fused at model 2: trunk_proj stored {out['tp']['trunk_master']}, {cut} of "
        f"{len(t0_['layout'])} tensors cut, gathered params bitwise on both ranks, first update vs world 1 "
        f"{tp_rel}, params after {MG_TP_ITERS} iterations within rtol {TP_RTOL} atol {TP_ATOL} (worst excess "
        f"{worst:.3g}); lstm_seq {out['lstm_seq_launches']}; {smi}")
    log(f"phase 20 (the rest of multi-GPU): {out['wall_s']:.1f} s (world 2 {world_s:.1f} s)")
    return out


# -- phase 21: the tools beside the package ------------------------------------

# (a): every BASELINE config through train/bench_configs.py's measurement:
# configs 3 and 4 in both modes, the others in the buffered mode, each cut
# from the CLI's 120 s games, 20 warm-up steps and best of 3 blocks of 100
# steps to BENCH_MAX_DOTA_TIME, BENCH_WARMUP and one block of BENCH_STEPS
BENCH_RUNS = ((3, "device"), (3, "fused"), (4, "device"), (4, "fused"), (1, "device"), (2, "device"),
              (5, "device"))
BENCH_MAX_DOTA_TIME, BENCH_WARMUP, BENCH_REPEATS, BENCH_STEPS = 20.0, 1, 1, 2
# (b): both curriculum stages as children, a few steps a stage, small games
CURRICULUM_ARGS = ("--stage1-steps", "2", "--stage2-steps", "2", "--n-envs", "8", "--eval-games", "8",
                   "--max-dota-time", "20")
# (c): the chaos supervisor's baseline scenario, 2 actors, the SIGTERM at
# CHAOS_STEPS and as many steps after the restore (from 10 and 10)
CHAOS_STEPS = 6
TOOLS_CHILD_S = 240.0
PHASE21_BUDGET_S = 150.0


def record_lstm_shapes(shapes):
    """Count each (B, T, D, H) the LSTM kernel is launched at in
    ``shapes`` (a Counter) by wrapping ``ops.lstm.kernel_plan``, which its
    wrapper calls once a launch. Returns the undo."""
    from dotaclient_tpu_torch.ops import lstm

    plan = lstm.kernel_plan

    def recorded(B, T, D, H, *sms):
        shapes[(B, T, D, H)] += 1
        return plan(B, T, D, H, *sms)

    lstm.kernel_plan = recorded
    return lambda: setattr(lstm, "kernel_plan", plan)


class BenchRecorder:
    """Wraps a bench learner's fused step (``fused``) or its collects and
    updates (``device``) to record, with no read of the device, each
    update's metrics, each chunk and the iterations; snapshots the params
    and zeroes the kernel's count when the learner is built."""

    def __init__(self, mode):
        self.mode, self.metrics, self.chunks = mode, [], []
        self.iterations = self.collects = self.updates = 0
        self.before = self.passes0 = None

    def __call__(self, learner, outs):
        from dotaclient_tpu_torch.ops import lstm

        if outs is not None:
            self.passes = learner.registry.snapshot().get("advantage/passes_total", 0.0) - self.passes0
            self.moved = check_params_moved(self.before, learner.policy, self.chunks)
            self.learner_lanes = learner.device_actor.n_lanes
            self.opponent_lanes = learner.device_actor.n_opp_lanes if learner.config.env.opponent == "league" else 0
            self.launches = lstm.lstm_sequence_kernel.launches
            self.steps_per_batch = learner.config.ppo.steps_per_batch
            return
        da = learner.device_actor
        rollout = da._rollout_impl

        def recorded_rollout(params, state, opp_params=None, **kw):
            out = rollout(params, state, opp_params, **kw)
            self.chunks.append(out[1])
            return out

        da._rollout_impl = recorded_rollout
        if self.mode == "fused":
            fused = learner.fused_step

            def recorded_fused(state, actor_state, opp_params=None):
                out = fused(state, actor_state, opp_params)
                self.iterations += 1
                self.metrics.append(out[2])
                return out

            learner.fused_step = recorded_fused
        else:
            collect, optimize = da.collect, learner._optimize

            def counted_collect(*args, **kw):
                self.collects += 1
                return collect(*args, **kw)

            def recorded_optimize(batch):
                m = optimize(batch)
                self.updates += 1
                self.metrics.append(m)
                return m

            da.collect, learner._optimize = counted_collect, recorded_optimize
        self.before = {k: v.detach().clone() for k, v in learner.policy.state_dict().items()}
        self.passes0 = learner.registry.snapshot().get("advantage/passes_total", 0.0)
        lstm.lstm_sequence_kernel.launches = 0

    def expected_launches(self, T):
        """The kernel's launches its iterations derive: a rollout step is one
        launch for the learner lanes and one for the opponent lanes of a
        league; a fused iteration updates once at E x M = 1, a buffered
        batch once an update plus its advantage passes."""
        sides = 2 if self.opponent_lanes else 1
        if self.mode == "fused":
            return self.iterations * (T * sides + 1)
        return self.collects * T * sides + self.updates + int(self.passes)


def bench_phase(device, seed):
    """(a): each BASELINE config through ``bench_configs.measure_config`` at
    the cut depth: frames/s, learner lanes, finite loss and ``health_ok`` 1
    in every update, every param moved, every action legal, and
    ``lstm_seq`` launched as the iterations derive, at shapes phase 2
    holds against the plain version."""
    from collections import Counter

    import torch

    from dotaclient_tpu_torch.config import RunConfig
    from dotaclient_tpu_torch.train import bench_configs

    rows, launches = [], {}
    for n, mode in BENCH_RUNS:
        rec, shapes = BenchRecorder(mode), Counter()
        undo = record_lstm_shapes(shapes)
        t0 = time.perf_counter()
        try:
            row, outs = bench_configs.measure_config(n, RunConfig(), mode=mode, seed=seed, device=device,
                                                     steps=BENCH_STEPS, warmup=BENCH_WARMUP,
                                                     repeats=BENCH_REPEATS, max_dota_time=BENCH_MAX_DOTA_TIME,
                                                     observe=rec)
        finally:
            undo()
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        what = f"config {n} ({mode})"
        cfg, _ = bench_configs.build_config(n, RunConfig())
        T = cfg.ppo.rollout_len
        heroes = cfg.env.team_size * (2 if cfg.env.opponent == "selfplay" else 1)
        if row["learner_lanes"] != cfg.env.n_envs * heroes:
            raise AssertionError(f"{what}: {row['learner_lanes']} learner lanes, expected {cfg.env.n_envs} games x "
                                 f"{heroes} heroes")
        steps = BENCH_WARMUP + BENCH_REPEATS * BENCH_STEPS
        iters = rec.iterations if mode == "fused" else rec.updates
        if iters != steps:
            raise AssertionError(f"{what}: {iters} {'iterations' if mode == 'fused' else 'updates'}, expected "
                                 f"{steps}")
        for i, m in enumerate(rec.metrics):
            loss, ok = float(m["loss"]), float(m["health_ok"])
            if not (np.isfinite(loss) and ok == 1.0):
                raise AssertionError(f"{what}: update {i}: loss {loss}, health_ok {ok}")
        illegal, n_actions = check_chunk_actions(rec.chunks)
        if illegal:
            raise AssertionError(f"{what}: {illegal} of {n_actions} sampled actions illegal under their masks")
        want = rec.expected_launches(T)
        if rec.launches != want or sum(shapes.values()) != rec.launches:
            raise AssertionError(f"{what}: lstm_seq launched {rec.launches} times ({sum(shapes.values())} by shape), "
                                 f"expected {want}: {rec.collects} collects, {rec.iterations} fused iterations, "
                                 f"{rec.updates} updates, {rec.passes:.0f} passes")
        unchecked = [s for s in shapes if s not in LSTM_SHAPES]
        if unchecked:
            raise AssertionError(f"{what}: lstm_seq launched at {unchecked}, shapes phase 2 does not check")
        key = f"bench_config{n}_{mode}"
        launches[key] = rec.launches
        rows.append({**row, "wall_s": wall_s, "lstm_seq_launches": rec.launches, "collects": rec.collects,
                     "updates": rec.updates, "iterations": rec.iterations, "passes": rec.passes,
                     "opponent_lanes": rec.opponent_lanes, "actions": n_actions,
                     "loss": [float(m["loss"]) for m in rec.metrics],
                     "shapes": {f"B={b} T={t}": c for (b, t, _, _), c in sorted(shapes.items())}})
        log(f"bench {what}: {row['end_to_end_frames_per_sec']} trained frames/s (best of {BENCH_REPEATS} block of "
            f"{BENCH_STEPS} steps after {BENCH_WARMUP} warm-up, {BENCH_MAX_DOTA_TIME:.0f} s games), "
            f"{row['learner_lanes']} learner lanes ({row['n_envs']} games, team {row['team_size']}"
            + (f", {rec.opponent_lanes} opponent lanes" if rec.opponent_lanes else "") + "); "
            f"loss {float(rec.metrics[-1]['loss']):.4g}, health_ok 1 in all {len(rec.metrics)} updates; "
            f"{n_actions} actions legal; lstm_seq launches {rec.launches} = "
            + (f"{rec.iterations} iterations x ({T} x {2 if rec.opponent_lanes else 1} + 1)" if mode == "fused" else
               f"{rec.collects} collects x {T}" + (" x 2" if rec.opponent_lanes else "")
               + f" + {rec.updates} updates + {rec.passes:.0f} passes")
            + f", by shape {rows[-1]['shapes']}; {wall_s:.1f} s")
    return {"rows": rows, "lstm_seq_launches": launches}


def curriculum_result(child, root):
    """(b)'s checks once the curriculum child exited: exit 0, a
    DEMO_SUMMARY a stage, stage 2 from stage 1's saved step, and stage 2's
    checkpoint equal to stage 1's bit for bit in every param its critic-only
    warm-up leaves (all but the value head, which moved)."""
    import os

    import torch

    from dotaclient_tpu_torch.utils.checkpoint import CheckpointManager

    rc = child.wait(TOOLS_CHILD_S)
    lines = child.lines()
    if rc != 0:
        raise AssertionError(f"the curriculum exited {rc}: {lines[-10:]} {child.stderr()[-2000:]}")
    summaries = [json.loads(line[len("DEMO_SUMMARY "):]) for line in lines if line.startswith("DEMO_SUMMARY ")]
    if [s["team_size"] for s in summaries] != [1, 5]:
        raise AssertionError(f"the curriculum's DEMO_SUMMARY lines: {summaries}")
    ck = os.path.join(root, "curriculum")
    w1, step1 = CheckpointManager(os.path.join(ck, "curriculum_stage1")).restore_weights()
    w2, step2 = CheckpointManager(os.path.join(ck, "curriculum_stage2")).restore_weights()
    if summaries[1]["restored_step"] != step1:
        raise AssertionError(f"stage 2 started from step {summaries[1]['restored_step']}, stage 1 saved {step1}")
    # both stages train against scripted_easy: no opponent lanes
    launches = [demo_launches(sm, f"curriculum stage {i}", opponent_lanes=False)
                for i, sm in enumerate(summaries, 1)]
    moved = sorted(k for k in w1 if not torch.equal(w1[k], w2[k]))
    if moved != ["head_value.bias", "head_value.weight"]:
        raise AssertionError(f"stage 2's checkpoint against stage 1's: changed {moved}, expected the value head "
                             "alone (the critic-only warm-up)")
    log(f"curriculum (b): stage 1 (1v1, hero pool {{1,2,3}}) saved step {step1}, stage 2 (5v5 --init-from it) "
        f"step {step2} with every param but the value head bit for bit stage 1's; lstm_seq launches {launches} "
        f"as derived; DEMO_SUMMARY stage 1 {summaries[0]}, stage 2 {summaries[1]}; {child.wall_s:.1f} s")
    return {"summaries": summaries, "stage1_step": step1, "stage2_step": step2, "wall_s": child.wall_s,
            "lstm_seq_launches": sum(launches)}


def chaos_result(child, root):
    """(c)'s checks once the chaos child exited: exit 0 and its
    CHAOS_SUMMARY ok with the scenario's evidence; the learners' launches
    from their ``done:`` lines."""
    import os

    rc = child.wait(TOOLS_CHILD_S)
    lines = child.lines()
    found = [json.loads(line[len("CHAOS_SUMMARY "):]) for line in lines if line.startswith("CHAOS_SUMMARY ")]
    if rc != 0 or len(found) != 1 or not found[0].get("ok"):
        raise AssertionError(f"the chaos supervisor exited {rc}: {lines[-10:]} {child.stderr()[-2000:]}")
    s = found[0]
    if not (s["learner1_exit"] == 0 == s["learner2_exit"] and s["actor_kills"] >= 1 and s["frames_corrupt_total"] >= 1
            and s["final_step"] == s["saved_step"] + CHAOS_STEPS):
        raise AssertionError(f"CHAOS_SUMMARY: {s}")
    work = os.path.join(root, "chaos")
    learners = []
    for phase in (1, 2):
        with open(os.path.join(work, f"learner{phase}.log")) as f:
            d = done_fields(f.read().splitlines(), f"the chaos learner {phase}")
        # minibatches 2: an update a minibatch (a step) and an advantage
        # pass a batch, the one a drain prefetched included (its record)
        _, scalars = read_record(os.path.join(work, f"learner{phase}.jsonl"))
        d["passes"] = int(scalars[-1]["advantage/passes_total"])
        if d["launches"] != d["steps"] + d["passes"]:
            raise AssertionError(f"the chaos learner {phase}: {d['launches']} lstm_seq launches, expected "
                                 f"{d['steps']} steps + {d['passes']} advantage passes")
        learners.append(d)
    # every actor incarnation that closed cleanly (the killed one prints
    # nothing) appends its ACTOR_STATS to its slot's log: a launch a step
    actors = []
    for i in range(2):
        with open(os.path.join(work, f"actor{i}.log")) as f:
            actors += [json.loads(x.split(" ", 1)[1]) for x in f.read().splitlines() if x.startswith("ACTOR_STATS ")]
    if len(actors) < s["clean_actor_exits"] or not sum(a["steps"] for a in actors):
        raise AssertionError(f"the chaos actors: {len(actors)} ACTOR_STATS lines for {s['clean_actor_exits']} clean "
                             f"exits: {actors}")
    for a in actors:
        if a["lstm_seq_launches"] != a["steps"]:
            raise AssertionError(f"a chaos actor: {a['lstm_seq_launches']} lstm_seq launches in {a['steps']} steps")
    log(f"chaos (c), baseline: CHAOS_SUMMARY {json.dumps(s, sort_keys=True)}; the learners' lstm_seq launches "
        f"{[d['launches'] for d in learners]} = steps {[d['steps'] for d in learners]} + advantage passes "
        f"{[d['passes'] for d in learners]}; the closed actors' {[a['lstm_seq_launches'] for a in actors]} = their "
        f"steps; {child.wall_s:.1f} s")
    return {"summary": s, "learners": learners, "actors": actors, "wall_s": child.wall_s,
            "lstm_seq_launches": sum(d["launches"] for d in learners),
            "actors_lstm_seq_launches": sum(a["lstm_seq_launches"] for a in actors)}


def start_tools(root, seed):
    """(b)'s and (c)'s children, started beside phase 20; each starts
    processes of its own: a kill takes its group."""
    import os

    children = {}
    try:
        children["curriculum"] = ModuleChild("dotaclient_tpu_torch.train.curriculum",
                                             ["--ckpt-root", os.path.join(root, "curriculum"), "--seed", str(seed),
                                              *CURRICULUM_ARGS], root, "curriculum")
        children["chaos"] = ModuleChild("dotaclient_tpu_torch.utils.chaos_run",
                                        ["--scenario", "baseline", "--actors", "2", "--seed", str(seed), "--workdir",
                                         os.path.join(root, "chaos"), "--keep-workdir", "--sigterm-at",
                                         str(CHAOS_STEPS), "--resume-steps", str(CHAOS_STEPS), "--timeout",
                                         str(TOOLS_CHILD_S - 10)], root, "chaos")
    except BaseException:
        for child in children.values():
            child.kill()
        raise
    return children


def tools_phase(device, seed, tools, smi=""):
    """Phase 21: (a) the BASELINE configs through bench_configs in this
    process, beside (b) the curriculum and (c) the chaos supervisor's
    baseline, ``tools`` = (their children, started beside phase 20, the
    directory of their logs); the phase within PHASE21_BUDGET_S."""
    t0 = time.perf_counter()
    children, root = tools
    bench = bench_phase(device, seed)
    a_s = time.perf_counter() - t0
    curriculum = curriculum_result(children["curriculum"], root)
    chaos = chaos_result(children["chaos"], root)
    out = {"bench": bench, "curriculum": curriculum, "chaos": chaos, "bench_s": a_s,
           "lstm_seq_launches": {**bench["lstm_seq_launches"], "curriculum": curriculum["lstm_seq_launches"],
                                 "chaos_learners": chaos["lstm_seq_launches"],
                                 "chaos_actors": chaos["actors_lstm_seq_launches"]},
           "wall_s": time.perf_counter() - t0}
    by = {f"{r['config']}/{r['mode']}": r["end_to_end_frames_per_sec"] for r in bench["rows"]}
    log(f"phase 21 (the tools beside the package): {out['wall_s']:.1f} s (bench {a_s:.1f} s, then {out['wall_s'] - a_s:.1f}"
        f" s until the children, started beside phase 20, ended); trained frames/s by config/mode {by}; {smi}")
    if out["wall_s"] > PHASE21_BUDGET_S:
        raise AssertionError(f"phase 21 took {out['wall_s']:.1f} s, over its budget of {PHASE21_BUDGET_S:.0f} s")
    return out


# -- phase 22: the checks and the preflight -------------------------------------

PHASE22_BUDGET_S = 120.0
CHECKS_CHILD_S = 110.0
# (b): the clean checked child against the unchecked one, at the --smoke
# sizes, every param tensor bitwise
CHECKIFY_STEPS = 4
GATE_STAGES = ("lint", "schema", "fused_parity", "router_failover")


class ShellChild(ModuleChild):
    """``bash SCRIPT`` as a child, as ``ModuleChild`` runs a module."""

    def __init__(self, script, root, name, env=None):
        import os
        import pathlib

        repo = str(pathlib.Path(__file__).resolve().parent)
        env = {**os.environ, "PYTHONPATH": repo + os.pathsep + os.environ.get("PYTHONPATH", ""),
               "PYTHONUNBUFFERED": "1", "PYTHON": sys.executable, **(env or {})}
        self.name, self.t0 = name, time.perf_counter()
        self._out, self._err = (open(os.path.join(root, f"{name}.{k}"), "w+") for k in ("out", "err"))
        self.proc = subprocess.Popen(["bash", os.path.join(repo, script)], cwd=repo, env=env, stdout=self._out,
                                     stderr=self._err, text=True, start_new_session=True)
        self.wall_s = None


# phase 22's children's sitecustomize (first on their PYTHONPATH, so every
# process they start runs it): when CHIP_SMOKE_SHAPES_DIR is set it wraps
# ops.lstm.kernel_plan, which the kernel's wrapper calls once a launch, as
# that module is imported, counts each launch's (B, T, D, H) in memory and
# writes the counts to DIR/<pid>.shapes at exit; then it runs the
# sitecustomize it shadows, if there is one
SHAPE_SHIM = r'''
import atexit
import collections
import importlib.abc
import importlib.machinery
import importlib.util
import os
import sys

_DIR = os.environ.get("CHIP_SMOKE_SHAPES_DIR")
_HERE = os.path.dirname(os.path.abspath(__file__))
_SHAPES = collections.Counter()


def _dump():
    if _SHAPES:
        with open(os.path.join(_DIR, f"{os.getpid()}.shapes"), "w") as f:
            f.writelines(f"{b} {t} {d} {h} {n}\n" for (b, t, d, h), n in _SHAPES.items())


class _Finder(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name != "dotaclient_tpu_torch.ops.lstm":
            return None
        spec = importlib.machinery.PathFinder.find_spec(name, path)
        run = spec.loader.exec_module

        def exec_module(module):
            run(module)
            plan = module.kernel_plan

            def recorded(B, T, D, H, *sms):
                _SHAPES[(B, T, D, H)] += 1
                return plan(B, T, D, H, *sms)

            module.kernel_plan = recorded

        spec.loader.exec_module = exec_module
        return spec


if _DIR:
    sys.meta_path.insert(0, _Finder())
    atexit.register(_dump)
_spec = importlib.machinery.PathFinder.find_spec(
    "sitecustomize", [p for p in sys.path if os.path.abspath(p or ".") != _HERE])
if _spec is not None:
    _spec.loader.exec_module(importlib.util.module_from_spec(_spec))
'''


def shape_env(root, name):
    """The environment that makes every process of the child ``name``
    count its ``lstm_seq`` launches by shape into ``root/shapes_name``:
    SHAPE_SHIM first on PYTHONPATH."""
    import os
    import pathlib

    shim = os.path.join(root, "shim")
    if not os.path.exists(os.path.join(shim, "sitecustomize.py")):
        os.makedirs(shim, exist_ok=True)
        with open(os.path.join(shim, "sitecustomize.py"), "w") as f:
            f.write(SHAPE_SHIM)
    out = os.path.join(root, f"shapes_{name}")
    os.makedirs(out, exist_ok=True)
    repo = str(pathlib.Path(__file__).resolve().parent)
    return {"CHIP_SMOKE_SHAPES_DIR": out,
            "PYTHONPATH": os.pathsep.join([shim, repo, os.environ.get("PYTHONPATH", "")])}


def logged_shapes(root, name):
    """The Counter of (B, T, D, H) the child ``name``'s processes launched
    ``lstm_seq`` at; every one must be a shape phase 2 checks."""
    import os
    from collections import Counter

    out = os.path.join(root, f"shapes_{name}")
    shapes = Counter()
    for fname in sorted(os.listdir(out)):
        with open(os.path.join(out, fname)) as f:
            for line in f:
                if line.strip():
                    b, t, d, h, n = (int(v) for v in line.split())
                    shapes[(b, t, d, h)] += n
    unchecked = [s for s in shapes if s not in LSTM_SHAPES]
    if unchecked:
        raise AssertionError(f"{name}: lstm_seq launched at {unchecked}, shapes phase 2 does not check")
    return shapes


def last_json(lines, what):
    for line in reversed(lines):
        if line.startswith("{"):
            return json.loads(line)
    raise AssertionError(f"{what} printed no JSON line: {lines[-5:]}")


def finished(child, what, expect_rc=0):
    rc = child.wait(CHECKS_CHILD_S)
    lines = child.lines()
    if expect_rc is not None and rc != expect_rc:
        raise AssertionError(f"{what} exited {rc}: {lines[-10:]} {child.stderr()[-3000:]}")
    return rc, lines


def preflight_result(child, count):
    """(a)'s preflight: ``ok`` at world ``count`` over NCCL; a SKIP fails."""
    _, lines = finished(child, "the preflight")
    out = last_json(lines, "the preflight")
    if out.get("skipped") or not out.get("ok") or out.get("mode") != "accelerator" \
            or out.get("backend") != "nccl" or out.get("n_devices") != count:
        raise AssertionError(f"the preflight: {out} {child.stderr()[-2000:]}")
    return out


def seconds_an_update(jsonl):
    """A learner child's seconds an update: its run's elapsed seconds over
    its optimizer steps (the record's closing line), and the mean of its
    ``learner/dispatch`` span (the checked update syncs, the unchecked only
    issues)."""
    _, scalars = read_record(jsonl)
    last = scalars[-1]
    disp = [s["span/learner/dispatch/mean_s"] for s in scalars if "span/learner/dispatch/mean_s" in s]
    return {"s_per_update": last["elapsed_sec"] / last["optimizer_steps"], "dispatch_mean_s": disp[-1],
            "steps": last["optimizer_steps"]}


def checkify_results(children, root):
    """(b): the clean checked child's params against the unchecked
    child's, the poisoned child's exit and the op it names, and both clean
    children's seconds an update."""
    import os
    import re

    import torch

    from dotaclient_tpu_torch.utils.checkpoint import CheckpointManager

    out, weights = {}, {}
    for name in ("checked", "plain"):
        _, lines = finished(children[name], f"the {name} learner")
        d = done_fields(lines, f"the {name} learner")
        weights[name], step = CheckpointManager(os.path.join(root, f"ck_{name}")).restore_weights()
        out[name] = {**d, **seconds_an_update(os.path.join(root, f"{name}.jsonl")), "ckpt_step": step,
                     "wall_s": children[name].wall_s}
        if step != CHECKIFY_STEPS:
            raise AssertionError(f"the {name} learner saved step {step}, expected {CHECKIFY_STEPS}")
    if set(weights["checked"]) != set(weights["plain"]):
        raise AssertionError(f"checkify's clean run saved {sorted(weights['checked'])}, the unchecked one "
                             f"{sorted(weights['plain'])}")
    diffs = {k: float((weights["checked"][k] - w).abs().max()) for k, w in weights["plain"].items()}
    unequal = [k for k, w in weights["plain"].items() if not torch.equal(weights["checked"][k], w)]
    if unequal:
        raise AssertionError(f"checkify's clean run against the unchecked one: {len(unequal)} of {len(diffs)} param "
                             f"tensors not bitwise; largest differences "
                             f"{sorted(diffs.items(), key=lambda kv: -kv[1])[:3]}")
    elements = sum(w.numel() for w in weights["plain"].values())
    rc, lines = finished(children["poisoned"], "the poisoned learner", expect_rc=None)
    err = children["poisoned"].stderr()
    m = re.search(r"FloatCheckError: nan generated by primitive: (\S+)", err)
    if rc == 0 or m is None:
        raise AssertionError(f"the poisoned checked learner exited {rc}: {err[-3000:]}")
    out.update({"params_bitwise": len(diffs), "params": len(diffs), "elements": elements,
                "poisoned_rc": rc, "poisoned_op": m.group(1).rstrip("."), "poisoned_wall_s": children["poisoned"].wall_s,
                "slowdown": out["checked"]["s_per_update"] / out["plain"]["s_per_update"]})
    return out


def cache_lines(lines, what):
    """A learner child's ``learner: compile cache DIR: kernels H in S s
    (PATH), codec H in S s (PATH)`` line, parsed."""
    import re

    for line in lines:
        if line.startswith("learner: compile cache "):
            found = dict((name, {"how": how, "seconds": float(sec), "path": path}) for name, how, sec, path in
                         re.findall(r"(codec|kernels) (built|loaded|unavailable) in ([0-9.]+) s \(([^)]*)\)", line))
            if set(found) == {"codec", "kernels"}:
                return found
    raise AssertionError(f"{what} printed no compile cache line: {lines[:10]}")


def gate_result(child):
    """(d): every stage of the gate passes; the tests stage skipped."""
    _, lines = finished(child, "the gate")
    stages = {line.split()[1]: line.split()[2] for line in lines if line.startswith("CI_GATE ")}
    want = {"tests": "SKIP", **{s: "PASS" for s in GATE_STAGES}}
    if stages != want:
        raise AssertionError(f"the gate's stages {stages}, expected {want}: {lines[-20:]} "
                             f"{child.stderr()[-2000:]}")
    return {"stages": stages, "wall_s": child.wall_s}


def start_checks(root, seed):
    """Phase 22's children, started beside phase 21: (d) the gate, ``bash
    dotaclient_tpu_torch/utils/ci_gate.sh`` with the tests stage skipped,
    and (a)-(c)'s but the second compile cache learner, which follows the
    first."""
    import os

    smoke = ["--smoke", "--steps", str(CHECKIFY_STEPS), "--seed", str(seed)]
    children = {}

    def start(name, module, args, env=None):
        children[name] = ModuleChild(module, args, root, name, env={**shape_env(root, name), **(env or {})})

    try:
        children["gate"] = ShellChild("dotaclient_tpu_torch/utils/ci_gate.sh", root, "gate",
                                      env={"CI_GATE_SKIP_TESTS": "1", **shape_env(root, "gate")})
        start("preflight", "dotaclient_tpu_torch.utils.run_multichip", [])
        for name, extra in (("checked", ["--checkify"]), ("plain", [])):
            start(name, "dotaclient_tpu_torch.train.learner",
                  smoke + extra + ["--checkpoint-dir", os.path.join(root, f"ck_{name}"), "--metrics-jsonl",
                                   os.path.join(root, f"{name}.jsonl")])
        start("poisoned", "dotaclient_tpu_torch.train.learner", smoke + ["--checkify"],
              env={"DOTA_FAULTS": "learner.nan_grad@1"})
        start("cache1", "dotaclient_tpu_torch.train.learner",
              ["--smoke", "--steps", "1", "--compile-cache", os.path.join(root, "cache")])
    except BaseException:
        for child in children.values():
            child.kill()
        raise
    return children


def checks_phase(device, seed, children, root, smi=""):
    """Phase 22: (a) the preflight, (b) checkify, (c) the compile cache and
    (d) the gate, their children in ``children`` (started beside phase 21
    by ``start_checks``; the caller kills them), their logs in ``root``;
    the second compile cache learner starts here, once the first ended, and
    joins ``children``. Every ``lstm_seq`` shape
    they launch is held against LSTM_SHAPES. (a)'s fused parity at 2 is
    phase 23's fused_multichip stage, checked there."""
    import os

    import torch

    t0 = time.perf_counter()
    count = torch.cuda.device_count()
    cache = os.path.join(root, "cache")
    preflight = preflight_result(children["preflight"], count)
    _, lines1 = finished(children["cache1"], "the first compile cache learner")
    first = cache_lines(lines1, "the first compile cache learner")
    mtimes = {k: os.path.getmtime(v["path"]) for k, v in first.items()}
    children["cache2"] = ModuleChild("dotaclient_tpu_torch.train.learner",
                                     ["--smoke", "--steps", "1", "--compile-cache", cache], root, "cache2",
                                     env=shape_env(root, "cache2"))
    checkify = checkify_results(children, root)
    _, lines2 = finished(children["cache2"], "the second compile cache learner")
    second = cache_lines(lines2, "the second compile cache learner")
    if not (all(v["how"] == "built" for v in first.values()) and all(v["how"] == "loaded"
                                                                    for v in second.values())
            and {k: os.path.getmtime(v["path"]) for k, v in second.items()} == mtimes
            and all(v["path"].startswith(cache) for v in second.values())):
        raise AssertionError(f"the compile cache: first child {first}, second {second}")
    gate = gate_result(children["gate"])
    launches = {}
    for name in ("preflight", "checked", "plain", "poisoned", "cache1", "cache2", "gate"):
        shapes = logged_shapes(root, name)
        launches[name] = {"launches": sum(shapes.values()),
                          "shapes": {f"B={b} T={t} D={d}": c for (b, t, d, _), c in sorted(shapes.items())}}
    # the children's own counts, where they report them, against the logs
    for name in ("checked", "plain"):
        if checkify[name]["launches"] != launches[name]["launches"]:
            raise AssertionError(f"the {name} learner's done: line counts {checkify[name]['launches']} lstm_seq "
                                 f"launches, its processes logged {launches[name]['launches']}")
    reported = preflight["lstm_seq_launches"]
    if reported != launches["preflight"]["launches"] or not reported:
        raise AssertionError(f"the preflight's ranks count {reported} lstm_seq launches, their processes logged "
                             f"{launches['preflight']['launches']}")
    for name in launches:
        if not launches[name]["launches"]:
            raise AssertionError(f"{name}'s processes launched lstm_seq no time")
    out = {"preflight": preflight, "checkify": checkify, "cache": {"first": first, "second": second}, "gate": gate,
           "launches": launches,
           "lstm_seq_launches": {f"checks_{k}": v["launches"] for k, v in launches.items()},
           "wall_s": time.perf_counter() - t0}
    c = checkify
    log(f"checks (a): preflight {preflight['tail']} ({preflight['backend_info']}); the fused parity at 2: phase 23's "
        f"fused_multichip stage")
    log(f"checks (b): checkify's clean run against the unchecked run from seed {seed}: {c['params_bitwise']} of "
        f"{c['params']} param tensors ({c['elements']} elements) bitwise; the poisoned run exited {c['poisoned_rc']} naming "
        f"{c['poisoned_op']}; seconds an update (the run's elapsed over its {c['checked']['steps']:.0f} steps, "
        f"rollouts included) checked {c['checked']['s_per_update']:.4f} against unchecked "
        f"{c['plain']['s_per_update']:.4f} ({c['slowdown']:.2f}x), learner/dispatch mean "
        f"{c['checked']['dispatch_mean_s']:.4f} against {c['plain']['dispatch_mean_s']:.4f} s; {smi}")
    log(f"checks (c): compile cache: first child {({k: (v['how'], round(v['seconds'], 2)) for k, v in first.items()})}, "
        f"second {({k: (v['how'], round(v['seconds'], 2)) for k, v in second.items()})}, mtimes unchanged; {smi}")
    log(f"checks (d): the gate {gate['stages']}, ended within {gate['wall_s']:.1f} s of its start beside phase 21; "
        f"lstm_seq launches by child "
        f"{({k: v['launches'] for k, v in launches.items()})}, shapes {({k: v['shapes'] for k, v in launches.items()})}")
    log(f"phase 22 (the checks and the preflight): {out['wall_s']:.1f} s; {smi}")
    if out["wall_s"] > PHASE22_BUDGET_S:
        raise AssertionError(f"phase 22 took {out['wall_s']:.1f} s, over its budget of {PHASE22_BUDGET_S:.0f} s")
    return out


# -- phase 23: the bench -----------------------------------------------------------

# ``python -m dotaclient_tpu_torch.bench --smoke``'s stages over three
# children side by side (they start beside phase 21): (a) the headline, the
# learner stages and the serve curve, (b) the multichip probes and the
# routed fleet, (c) the five planes' A/Bs and the fused parity at 2 (phase
# 22 (a)'s, with frames/s)
BENCH_CHILDREN = {"bench_a": ("headline", "transport", "stall", "quantize", "advantage", "serve"),
                  "bench_b": ("multichip", "serve_fleet"),
                  "bench_c": ("health", "trace", "fleet", "outcome", "utilization", "fused_multichip")}
BENCH_CHILD_S = 240.0
PHASE23_BUDGET_S = 150.0
# the stages' gates: parity digests and completion at 1, the bf16 wire's
# compression at the reference's bar
BENCH_AT_1 = ("multichip_parity", "advantage_parity", "serve_parity", "serve_fleet_rehome_parity",
              "serve_fleet_complete", "fused_multichip_parity")
BENCH_COMPRESSION = 1.8


def start_bench(root, seed):
    """Phase 23's children, each with SHAPE_SHIM (its grandchildren too)."""
    import os

    children = {}
    try:
        for name, stages in BENCH_CHILDREN.items():
            args = ["--smoke", "--seed", str(seed), "--anchor", os.path.join(root, f"anchor_{name}.json")]
            children[name] = ModuleChild("dotaclient_tpu_torch.bench",
                                         args + [a for st in stages for a in ("--stage", st)], root, name,
                                         env=shape_env(root, name))
    except BaseException:
        for child in children.values():
            child.kill()
        raise
    return children


def rates(tree, path=""):
    """Every frames/s of a bench line (``*frames_per_sec``, ``*_fps*``):
    (path, value)."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from rates(v, f"{path}.{k}" if path else k)
    elif isinstance(tree, (int, float)) and not isinstance(tree, bool) and (
            path.endswith("frames_per_sec") or "_fps" in path.rsplit(".", 1)[-1] or path == "value"):
        yield path, tree


def session_left(sid, wait_s=15.0):
    """The processes of session ``sid`` still running (pid, command line)
    after at most ``wait_s``: a child's helpers (a shared-memory resource
    tracker) end on their own soon after it does."""
    import os

    deadline = time.monotonic() + wait_s
    while True:
        left = []
        for pid in (p for p in os.listdir("/proc") if p.isdigit()):
            try:
                with open(f"/proc/{pid}/stat") as f:
                    fields = f.read().rsplit(")", 1)[1].split()
                if int(fields[3]) != sid or fields[0] == "Z":   # the session id; zombies are gone
                    continue
                with open(f"/proc/{pid}/cmdline", "rb") as f:
                    left.append((int(pid), f.read().replace(b"\0", b" ").decode(errors="replace")[:200]))
            except (OSError, IndexError, ValueError):
                continue
        if not left or time.monotonic() > deadline:
            return left
        time.sleep(0.2)


def bench_result(child, root, stages):
    """A bench child's line, once it exited: exit 0, no stage's error, its
    stages' gates, every frames/s finite and above 0, its processes gone,
    every ``lstm_seq`` shape they launched in LSTM_SHAPES."""
    import os

    rc = child.wait(BENCH_CHILD_S)
    lines = child.lines()
    line = last_json(lines, child.name) if lines else {}
    errors = {k: v["error"] for k, v in line.items() if isinstance(v, dict) and "error" in v}
    if rc != 0 or errors or "error" in line or len(lines) != 1:
        raise AssertionError(f"{child.name} exited {rc}: errors {errors} {line.get('error')}; "
                             f"{child.stderr()[-3000:]}")
    left = session_left(child.proc.pid)
    if left:
        raise AssertionError(f"{child.name} left processes of its session running: {left}")
    gates = {k: line["stages"][k] for k in BENCH_AT_1 if line["stages"].get(k) is not None}
    if any(v < 1.0 for v in gates.values()):
        raise AssertionError(f"{child.name}: stage gates below 1: {gates}")
    comp = line["stages"].get("rollout_compression")
    if comp is not None and comp < BENCH_COMPRESSION:
        raise AssertionError(f"{child.name}: rollout_compression {comp} under {BENCH_COMPRESSION}")
    bad = [(k, v) for k, v in rates(line) if not (np.isfinite(v) and v > 0)]
    found = dict(rates(line))
    if bad or ("headline" in stages and "end_to_end_frames_per_sec" not in found):
        raise AssertionError(f"{child.name}: frames/s not finite and above 0: {bad}")
    missing = [st for st in stages if st != "headline" and not isinstance(line.get(st), dict)]
    if missing:
        raise AssertionError(f"{child.name}: no result for {missing}")
    shapes = logged_shapes(root, child.name)
    return {"line": line, "gates": gates, "wall_s": child.wall_s, "launches": sum(shapes.values()),
            "shapes": {f"B={b} T={t} D={d}": c for (b, t, d, _), c in sorted(shapes.items())}}


def bench_smoke_phase(children, root, smi=""):
    """Phase 23: the bench's children (started beside phase 21) to their
    ends and their lines checked; the fused_multichip stage stands in for
    phase 22 (a)'s fused parity at 2 and is held to its checks."""
    t0 = time.perf_counter()
    out = {name: bench_result(child, root, BENCH_CHILDREN[name]) for name, child in children.items()}
    fused = out["bench_c"]["line"]["fused_multichip"]
    if not (fused["fused_multichip_parity"] == 1.0 and fused["lane_sharded"] and fused["device"] == "cuda"
            and fused["lanes"]["per_rank"] == [2, 2] and fused["n_devices"] == 2):
        raise AssertionError(f"the fused parity at 2 (fused_multichip): {fused}")
    for name, r in out.items():
        if not r["launches"]:
            raise AssertionError(f"{name}'s processes launched lstm_seq no time")
    if fused["lstm_seq_launches"] > out["bench_c"]["launches"]:
        raise AssertionError(f"the fused parity's ranks count {fused['lstm_seq_launches']} lstm_seq launches, "
                             f"bench_c's processes logged {out['bench_c']['launches']}")
    lines = {name: r["line"] for name, r in out.items()}
    a, b, c = lines["bench_a"], lines["bench_b"], lines["bench_c"]
    st = {**a["stages"], **{k: v for x in (b, c) for k, v in x["stages"].items() if v is not None}}
    log(f"bench (a): --smoke headline {a['value']} optimizer frames/s, end to end {a['end_to_end_frames_per_sec']}, "
        f"fused {a['fused_frames_per_sec']}, k8 {a['fused_k8_frames_per_sec']}, actor {a['actor_frames_per_sec']}; "
        f"shm_vs_socket {a['transport']['shm_vs_socket']}, stall recoveries {st['stall_sync_recovery']} / "
        f"{st['stall_async_recovery']}, rollout_compression {st['rollout_compression']}, advantage_speedup "
        f"{st['advantage_speedup']} (smoke depth: checks, not measurements; {smi})")
    log(f"bench (a): serve parity {st['serve_parity']}, best window {a['serve']['best_window']}; (b): multichip "
        f"parity {st['multichip_parity']} over {b['multichip']['backend']}; serve_fleet complete "
        f"{st['serve_fleet_complete']}, re-home parity {st['serve_fleet_rehome_parity']}, blackout p99 "
        f"{st['serve_fleet_blackout_p99_ms']} ms")
    log(f"bench (c): overheads health {st['health_overhead']}, trace {st['trace_overhead']}, fleet "
        f"{st['fleet_overhead']}, outcome {st['outcome_overhead']}, utilization {st['utilization_overhead']}; the "
        f"fused parity at 2 on the card over gloo (phase 22 (a)'s): losses {fused['parity']['max_abs_loss_diff']:.3g} "
        f"apart, param L1 {fused['parity']['param_l1']}, lanes {fused['lanes']}")
    log(f"bench: children's walls {({k: round(r['wall_s'], 1) for k, r in out.items()})} s, lstm_seq launches "
        f"{({k: r['launches'] for k, r in out.items()})}, shapes {({k: r['shapes'] for k, r in out.items()})}")
    result = {"children": out, "wall_s": time.perf_counter() - t0,
              "lstm_seq_launches": {name: r["launches"] for name, r in out.items()}}
    log(f"phase 23 (the bench): {result['wall_s']:.1f} s after phase 22 (the children started with 21); {smi}")
    return result


# -- phase 24: the wide core on the grid-wide kernel ----------------------------


def wide_model(cfg):
    """``cfg`` with the LSTM at hidden_dim WIDE_HIDDEN, every other model
    field at its default."""
    from dotaclient_tpu_torch.config import ModelConfig

    return dataclasses.replace(cfg, model=ModelConfig(hidden_dim=WIDE_HIDDEN))


def reset_launches():
    """Both plans' launch counts and their total to 0."""
    from dotaclient_tpu_torch.ops import lstm

    lstm.lstm_sequence_kernel.launches = 0
    for kind in lstm.lstm_sequence_kernel.launches_by_plan:
        lstm.lstm_sequence_kernel.launches_by_plan[kind] = 0


def plan_launches(what, grid):
    """The launches by plan since ``reset_launches``; raises unless the grid
    plan's are ``grid`` and the cluster plan's 0."""
    from dotaclient_tpu_torch.ops import lstm

    got = dict(lstm.lstm_sequence_kernel.launches_by_plan)
    if got != {"cluster": 0, "grid": grid} or lstm.lstm_sequence_kernel.launches != grid:
        raise AssertionError(f"{what}: lstm_seq launched {got} by plan ({lstm.lstm_sequence_kernel.launches} in "
                             f"all), expected {grid} on the grid plan and none on the cluster plan")
    return got


def wide_train(device, seed):
    """(a) phase 6's fused learner at the wide core: warm-up, the timed
    iterations under the sync guard, a profiled window."""
    import torch

    from dotaclient_tpu_torch.train.learner import Learner
    from dotaclient_tpu_torch.utils import telemetry

    cfg = wide_model(train_config(seed))
    T = cfg.ppo.rollout_len
    updates = cfg.ppo.steps_per_batch * cfg.steps_per_dispatch
    learner = Learner(cfg, actor="fused", seed=seed, device=device, registry=telemetry.Registry())
    rec = Recorder(learner)
    unguarded_end(learner)
    before = {k: v.detach().clone() for k, v in learner.policy.state_dict().items()}
    try:
        torch.cuda.synchronize()
        reset_launches()
        learner.train(WIDE_WARM * updates)
        torch.cuda.synchronize()
        rec.clear()
        out, wall_s = guarded_train(learner, WIDE_TIMED * updates)
        metrics = [{k: float(v) for k, v in m.items()} for m in rec.metrics]
        for i, m in enumerate(metrics):
            if not (np.isfinite(m["loss"]) and np.isfinite(m["grad_norm"]) and m["health_ok"] == 1.0):
                raise AssertionError(f"wide timed iteration {i}: loss {m['loss']}, grad_norm {m['grad_norm']}, "
                                     f"health_ok {m['health_ok']}")
        frames = WIDE_TIMED * learner.device_actor.n_lanes * T
        if out["frames_trained"] != frames or len(metrics) != WIDE_TIMED:
            raise AssertionError(f"{out['frames_trained']} frames in {len(metrics)} iterations, expected {frames}")
        rollout_ms = statistics.mean(a.elapsed_time(b) for a, b, _ in rec.marks)
        update_ms = statistics.mean(b.elapsed_time(c) for _, b, c in rec.marks)
        chunks = list(rec.chunks)
        rec.clear()
        profile = profiled(lambda: learner.train(WIDE_PROFILED * updates))
        iters = WIDE_WARM + WIDE_TIMED + WIDE_PROFILED
        launches = plan_launches("wide train", iters * (T + updates))
    finally:
        rec.close()
        learner.close()
    moved, _, _ = check_params_moved(before, learner.policy, chunks)
    illegal, n_actions = check_chunk_actions(chunks)
    if illegal:
        raise AssertionError(f"wide train: {illegal} of {n_actions} sampled actions illegal under their masks")
    result = {
        "hidden_dim": cfg.model.hidden_dim, "n_envs": cfg.env.n_envs, "lanes": learner.device_actor.n_lanes,
        "rollout_len": T, "updates_per_iteration": updates, "warm_iterations": WIDE_WARM,
        "timed_iterations": WIDE_TIMED, "profiled_iterations": WIDE_PROFILED, "frames_trained": frames,
        "frames_per_s": frames / wall_s, "iteration_ms": wall_s * 1e3 / WIDE_TIMED,
        "rollout_ms": rollout_ms, "update_ms": update_ms, "lstm_seq_launches": launches,
        "actions_checked": n_actions, "params_moved": sum(moved.values()), "params": len(moved),
        "last_metrics": metrics[-1], "sync_debug_mode": "error", "profile": profile,
    }
    log(
        f"wide train (hidden_dim {cfg.model.hidden_dim}): {WIDE_TIMED} timed fused iterations x "
        f"{learner.device_actor.n_lanes} lanes x {T} steps = {frames} trained frames in {wall_s * 1e3:.1f} ms: "
        f"{result['frames_per_s']:.0f} frames/s, {result['iteration_ms']:.2f} ms an iteration (rollout "
        f"{rollout_ms:.2f} ms, update {update_ms:.2f} ms between CUDA events); loss {metrics[-1]['loss']:.4g}, "
        f"grad_norm {metrics[-1]['grad_norm']:.4g}, health_ok 1 in all; {n_actions} actions legal; "
        f"{sum(moved.values())} of {len(moved)} param tensors moved; lstm_seq launches by plan {launches}"
    )
    log_profile(f"wide train profile: {WIDE_PROFILED} iterations", profile)
    return result


def wide_serve(device, seed):
    """(b) phase 3's serving traffic on a ServeEngine at the wide core: the
    counted run, the bitwise replay through the kernel, and the replay
    through the plain version with its control."""
    from dotaclient_tpu_torch.config import RunConfig
    from dotaclient_tpu_torch.models import convert, random_flax_params

    cfg = wide_model(RunConfig())
    params = convert(random_flax_params(cfg, seed, value_head=False))
    params2 = convert(random_flax_params(cfg, seed + 1, value_head=False))
    engine, snap, requests, replies, releases, wall = serve_stream(cfg, params, params2, device, seed, "wide serve",
                                                                   reset_launches)
    dispatches = int(snap["serve/dispatches_total"])
    launches = plan_launches("wide serve", dispatches)
    n = N_GAMES * N_STEPS
    by_version = {0: params, 1: params2}
    reset_launches()
    mismatches, n_replayed = replay(engine, requests, replies, releases, N_GAMES, by_version)
    if mismatches:
        raise AssertionError(f"wide serve: reference_step replay: {mismatches} of {n} replies differ")
    plan_launches("wide serve replay", n_replayed)
    reset_launches()
    plain_err, flips, rows = plain_replay(engine, requests, replies, releases, N_GAMES, by_version)
    zeroed_err, _, _ = plain_replay(engine, requests, replies, releases, N_GAMES, by_version, zeroed=True)
    plan_launches("wide serve plain replay", 0)
    if not (rows == n and plain_err <= SOCKET_LOGP_ATOL < zeroed_err):
        raise AssertionError(f"wide serve: {rows} rows replayed on the plain version; served log-probs {plain_err} "
                             f"from the plain version's (limit {SOCKET_LOGP_ATOL}), {zeroed_err} with the carries "
                             "zeroed (must read above it)")
    lat_ms = np.asarray([(r[5] - requests[r[0]][3]) * 1e3 for r in replies])
    result = {
        "hidden_dim": cfg.model.hidden_dim, "requests": n, "dispatches": dispatches,
        "requests_per_s": n / wall, "request_p50_ms": float(np.percentile(lat_ms, 50)),
        "request_p99_ms": float(np.percentile(lat_ms, 99)),
        "dispatch_mean_ms": snap["span/serve/dispatch/mean_s"] * 1e3,
        "replay": "bitwise", "replayed_dispatches": n_replayed,
        "logp_err_vs_plain": plain_err, "plain_sample_flips": flips, "logp_err_vs_plain_zeroed_carry": zeroed_err,
        "lstm_seq_launches": launches,
    }
    log(
        f"wide serve (hidden_dim {cfg.model.hidden_dim}): {n} requests, {dispatches} dispatches, "
        f"{result['requests_per_s']:.0f} req/s, request p50 {result['request_p50_ms']:.3f} ms p99 "
        f"{result['request_p99_ms']:.3f} ms, dispatch mean {result['dispatch_mean_ms']:.3f} ms; replay bitwise "
        f"over {n_replayed} dispatches; served log-probs within {plain_err:.3g} of the plain version's (limit "
        f"{SOCKET_LOGP_ATOL}; {flips} of {rows} rows' own samples differed; carries zeroed: {zeroed_err:.3g}); "
        f"lstm_seq launches by plan {launches}"
    )
    return result


def wide_core_phase(device, seed, smi=""):
    """Phase 24: the LSTM at hidden_dim WIDE_HIDDEN, trained and served on
    the grid-wide kernel."""
    result = {"train": wide_train(device, seed), "serve": wide_serve(device, seed)}
    result["grid_launches"] = result["train"]["lstm_seq_launches"]["grid"] + result["serve"]["lstm_seq_launches"]["grid"]
    log(f"wide core: the grid plan launched {result['grid_launches']} times on the path, the cluster plan 0; {smi}")
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
    from dotaclient_tpu_torch.ops import build, lstm  # the port must sit beside this script

    torch.backends.cuda.matmul.allow_tf32 = False   # plain f32 versions in full f32
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, CUDA {torch.version.cuda}, {smi}")

    phase_s = {}

    def timed(label, fn, *fn_args):
        """``fn(*fn_args)``, its seconds logged on a line of their own."""
        t = time.perf_counter()
        out = fn(*fn_args)
        phase_s[label] = time.perf_counter() - t
        log(f"phase {label}: {phase_s[label]:.1f} s")
        return out

    t_start = time.perf_counter()
    timed("1 (build)", build.kernel_library, True)
    build_s = phase_s["1 (build)"]
    lstm_entry, grid_entry, lstm_extra = timed("2 (kernels)", check_lstm_kernel, device, args.seed)
    lstm_extra["sweep"] = timed("2 (sweep)", lstm_sweep, device, args.seed)
    serve = timed("3 (serve)", serve_phase, device, args.seed)
    serve_profile = timed("4 (serve profile)", profile_serve, device, args.seed)
    lstm_extra["backward"] = timed("5 (backward)", check_lstm_backward, device, args.seed)
    train, learner, chunk = timed("6 (train)", train_phase, device, args.seed)
    train["kernel_vs_plain"] = timed("7 (kernel in the train step)", check_train_step_kernel, learner, chunk)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_") as ckpt_dir:
        sock = timed("8 (socket)", socket_phase, device, args.seed, learner, ckpt_dir, serve)
        sock["cli"] = timed("9 (serve CLI)", cli_phase, ckpt_dir, learner.state.step, args.seed)
        fleet = {"parity": timed("10 (fleet parity)", fleet_parity_phase, device, args.seed, ckpt_dir),
                 "cli": timed("11 (fleet processes)", fleet_cli_phase, ckpt_dir, learner.state.step, args.seed)}
        league = timed("12 (league)", league_phase, device, args.seed, ckpt_dir)
        buffered = timed("13 (buffered)", buffered_phase, device, args.seed, ckpt_dir, train["frames_per_s"])
    record = timed("14 (run record)", run_record_phase, device, args.seed, smi)
    external = timed("15 (external actors)", external_actors_phase, device, args.seed, smi)
    scalar = timed("16 (scalar path, shm lane)", scalar_path_phase, device, args.seed,
                   external["external"]["frames_per_s_steps_10_to_30"], smi)
    phase17 = timed("17 (transformer, MoE)", transformer_phase, device, args.seed, league["frames_per_s"])
    phase18 = timed("18 (wire)", wire_phase, device, args.seed, external["external"], smi)
    phase19 = timed("19 (data parallel)", data_parallel_phase, device, args.seed, smi)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_late_") as late:
        children = start_tools(late, args.seed)   # phase 21 (b) and (c), beside phase 20
        try:
            phase20 = timed("20 (multi-GPU)", multigpu_rest_phase, device, args.seed, smi)
            # phases 22's and 23's children, beside phase 21 (checks_phase
            # adds its second compile cache learner to ``children``)
            children.update(start_checks(late, args.seed))
            bench_children = start_bench(late, args.seed)
            children.update(bench_children)
            phase21 = timed("21 (tools)", tools_phase, device, args.seed,
                            ({k: children[k] for k in ("curriculum", "chaos")}, late), smi)
            # phase 24 in this process, beside the children of 22 and 23
            if lstm.lstm_sequence_kernel.launches_by_plan["grid"] != lstm_extra["grid_check_launches"]:
                raise AssertionError(
                    f"the grid plan launched {lstm.lstm_sequence_kernel.launches_by_plan['grid']} times in this "
                    f"process by phase 21, {lstm_extra['grid_check_launches']} of them phase 2's checks: an H=128 "
                    "path took it")
            phase24 = timed("24 (wide core)", wide_core_phase, device, args.seed, smi)
            grid_entry["launches"] = phase24["grid_launches"]
            phase22 = timed("22 (checks)", checks_phase, device, args.seed, children, late, smi)
            phase23 = timed("23 (bench)", bench_smoke_phase, bench_children, late, smi)
            if phase_s["22 (checks)"] + phase_s["23 (bench)"] > PHASE22_BUDGET_S + PHASE23_BUDGET_S:
                raise AssertionError(f"phases 22 and 23 took {phase_s['22 (checks)'] + phase_s['23 (bench)']:.1f} s, "
                                     f"over their budget of {PHASE22_BUDGET_S + PHASE23_BUDGET_S:.0f} s")
        finally:
            for child in children.values():
                child.kill()
    frames = {r["config"]: r["end_to_end_frames_per_sec"] for r in phase21["bench"]["rows"] if r["mode"] == "fused"}
    log(f"configs 3 and 4 fused {frames} trained frames/s against phase 6's fused config-1 learner "
        f"{train['frames_per_s']:.0f} in this run: {frames[3] / train['frames_per_s']:.3f}x and "
        f"{frames[4] / train['frames_per_s']:.3f}x; {smi}")
    log(f"phases 1-24: {time.perf_counter() - t_start:.1f} s; "
        + ", ".join(f"{k.split(' ')[0]} {v:.1f}" for k, v in phase_s.items()))
    lstm_entry["launches_by_path"] = {"serve": serve["lstm_seq_launches"], "train": train["lstm_seq_launches"],
                                      "serve_socket": sock["lstm_seq_launches"],
                                      "serve_fleet_parity": fleet["parity"]["lstm_seq_launches"],
                                      "serve_fleet_processes": fleet["cli"]["lstm_seq_launches"],
                                      "train_league": league["lstm_seq_launches"],
                                      "league_demo": league["children"]["demo"]["lstm_seq_launches"],
                                      "league_eval": league["eval"]["lstm_seq_launches"],
                                      "train_buffered": buffered["lstm_seq_launches"],
                                      "train_run_record": record["lstm_seq_launches"],
                                      "train_vec": external["vec"]["lstm_seq_launches"],
                                      "train_vec_traced": external["vec_traced"]["lstm_seq_launches"],
                                      "external_learner": external["external"]["lstm_seq_launches"],
                                      "external_actors": external["external"]["actors_lstm_seq_launches"],
                                      "train_scalar": scalar["scalar"]["lstm_seq_launches"],
                                      "train_scalar_cli": sum(scalar["cli"][k]["lstm_seq_launches"]
                                                              for k in ("scalar", "no_vec")),
                                      "eval_served": scalar["eval_served"]["lstm_seq_launches"],
                                      "shm_learner": scalar["shm"]["lstm_seq_launches"],
                                      "shm_actors": scalar["shm"]["actors_lstm_seq_launches"],
                                      "train_transformer": phase17["league"]["lstm_seq_launches"],
                                      "wire_learner": phase18["external"]["lstm_seq_launches"],
                                      "wire_actors": phase18["external"]["actors_lstm_seq_launches"],
                                      "train_buffered_narrow": phase18["buffered"]["lstm_seq_launches"],
                                      **{f"data_parallel_{k}": v
                                         for k, v in phase19["lstm_seq_launches"].items()},
                                      **{f"multigpu_{k}": v for k, v in phase20["lstm_seq_launches"].items()},
                                      **phase21["lstm_seq_launches"],
                                      **phase22["lstm_seq_launches"],
                                      **phase23["lstm_seq_launches"]}
    lstm_entry["launches"] = sum(lstm_entry["launches_by_path"].values())

    from dotaclient_tpu_torch.transport import serialize

    calls = serialize.codec_calls()
    if calls["proto_fallbacks"] or not calls["native_decodes"]:
        raise AssertionError(f"this process's rollout codec: {calls} (native calls and no fallback expected)")
    log(f"this process's rollout codec over every phase: {calls}")

    kernels = {"kernels": [lstm_entry, grid_entry]}
    if args.out:
        with open(args.out, "w") as f:
            json.dump({**kernels, "lstm_seq_extra": lstm_extra, "serve": serve, "build_s": build_s, "card": smi,
                       "profile": serve_profile, "train": train, "socket": sock, "fleet": fleet,
                       "league": league, "buffered": buffered, "run_record": record, "external": external,
                       "scalar": scalar, "phase17": phase17, "phase18": phase18, "phase19": phase19,
                       "phase20": phase20, "phase21": phase21, "phase22": phase22, "phase23": phase23,
                       "phase24": phase24, "phase_s": phase_s}, f,
                      indent=2)
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
