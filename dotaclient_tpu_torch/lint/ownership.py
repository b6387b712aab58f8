"""thread-ownership pass: declarative per-thread state ownership, checked.

The learner stack is a small fleet of threads: the train thread, the
snapshot engine's thread, the transport's accept/reader/writer threads, an
optional in-process actor thread. Shared-state races between them were the
JAX package's most frequent post-review fixes (the ``_pending_best`` swap,
the ``_last_verdict_m`` re-fold after a rollback, the sync-gate fold
ordering); its answer was a *declared* ownership model a machine re-checks
on every commit. This module is that model for the port: the counterpart
of the JAX package's ``lint/ownership.py``, class for class, with the same
thread labels and the same attributes, as the port names them.

``OWNERSHIP`` below is the declaration. For each mapped class:

* ``default_thread`` + ``methods`` assign every method (and named nested
  def — closures resolve to the innermost declared name) to the thread it
  runs on;
* ``attrs`` maps each guarded attribute to its discipline:

  - ``"<thread>"`` — only methods on that thread may touch it;
  - ``"lock:<attr>"`` — any thread, but the access must be lexically
    inside ``with self.<attr>:`` (or in a method listed in ``holds`` as
    called-with-the-lock-held, the ``*_locked`` helper convention);
  - ``"any"`` — explicitly unguarded (documented free-for-all, e.g. a
    latched bool the readers tolerate stale).

Unmapped attributes are unchecked: the map is a statement of the
disciplines that matter, not an inventory. ``__init__`` is exempt — the
object is not shared until construction returns. Deliberate exceptions
(handoff-after-barrier reads, monotonic-value races) are waived at the
line with ``# lint-ok: thread-ownership(<why>)`` so the reasoning is in
the diff, not in a code review's memory.

The race shapes that motivated the pass are fixtures in
``tests/test_torch_lint.py``, held against the JAX package's pass.
"""

from __future__ import annotations

import ast
import dataclasses
from typing import Dict, Iterable, List, Mapping, Tuple

from dotaclient_tpu_torch.lint.core import Diagnostic, FileCtx, Rule, dotted_name


@dataclasses.dataclass(frozen=True)
class ClassMap:
    default_thread: str
    methods: Mapping[str, str] = dataclasses.field(default_factory=dict)
    attrs: Mapping[str, str] = dataclasses.field(default_factory=dict)
    # method name → lock attrs the CALLER is contractually holding (the
    # `_locked`-suffix helper convention: the lock is acquired upstream)
    holds: Mapping[str, Tuple[str, ...]] = dataclasses.field(
        default_factory=dict
    )


# The shipped ownership model. Thread names are labels, not OS identities:
# "train" = the thread running Learner.train(), "engine" = the snapshot
# thread, "reader"/"writer"/"accept" = the transport's per-connection and
# accept threads, "learner" = the single consuming/publishing side of a
# transport object.
OWNERSHIP: Dict[str, Dict[str, ClassMap]] = {
    "dotaclient_tpu_torch/train/learner.py": {
        "Learner": ClassMap(
            default_thread="train",
            methods={
                # the asynchronous log boundary's continuation (the
                # reference's _finish_metrics): a closure of _log_boundary
                # that runs ON the snapshot thread (submit_metrics)
                "finish": "engine",
                # overlap mode's in-process actor pool thread
                "actor_loop": "actor",
                # signal-handler entry: one latched flag write
                "request_stop": "any",
            },
            attrs={
                # the train state: updates in flight on the card read and
                # write its params and moments in place, so only the train
                # thread, which issued them, may ever touch it
                "state": "train",
                # deferred best-model candidate: written by the snapshot
                # thread's metrics continuation, consumed on the train
                # thread; the swap is lock-protected
                "_pending_best": "lock:_pending_best_lock",
                # sync-gate fold state: cleared by rollback and folded by
                # sync boundaries, all on the train thread
                "_last_verdict_m": "train",
                "_prefetched": "train",
                "_prefetch_ticket": "train",
                "_mb_rng": "train",
                "_mb_draws": "train",
                # the host step counter (the reference's _host_step; its
                # _host_version is the port's state.version, under "state")
                "_steps_done": "train",
                "_dispatch_inflight": "train",
                "_stall_s": "train",
                "_published_version": "train",
                "_rollback_count": "train",
                "_best_win": "train",
                "_last_metrics": "train",
                # utilization accountant: phase intervals and folds all
                # happen on the train thread's loop
                "_util": "train",
                # latched stop flag: written by the signal handler, read by
                # every loop; single bool write, stale reads are the design
                "_stop_requested": "any",
            },
        ),
    },
    "dotaclient_tpu_torch/train/snapshot.py": {
        "SnapshotEngine": ClassMap(
            default_thread="train",   # submit/drain/stop: caller side
            methods={
                "_run": "engine",
                "_fetch": "engine",
                "_do_publish": "engine",
                "_do_checkpoint": "engine",
                "_do_metrics": "engine",
            },
            attrs={
                "_jobs": "lock:_cond",
                "_stats_jobs": "lock:_cond",
                "_busy": "lock:_cond",
                "_stopped": "lock:_cond",
                # engine-private monotonic floor; the train thread reads it
                # only after drain() (waived at the property)
                "_last_published": "engine",
            },
            holds={"_pending_locked": ("_cond",)},
        ),
    },
    "dotaclient_tpu_torch/train/health.py": {
        "HealthMonitor": ClassMap(
            default_thread="any",   # called from train AND engine threads
            attrs={
                "_pending": "lock:_lock",
                "_gen": "lock:_lock",
                "_ema_grad": "lock:_lock",
                "_healthy_folds": "lock:_lock",
                "_unhealthy": "lock:_lock",
            },
        ),
    },
    "dotaclient_tpu_torch/transport/socket_transport.py": {
        "TransportServer": ClassMap(
            default_thread="learner",
            methods={
                "_accept_loop": "accept",
                "_reader_loop": "reader",
                "_poison": "reader",
                "_enqueue_rollouts": "reader",
                "_writer_loop": "writer",
                # torn down from readers, writers, publish, and close alike;
                # it touches only lock-guarded state and the conn's own cond
                "_drop": "any",
                "close": "any",
            },
            attrs={
                "_rollouts": "lock:_roll_cond",
                "_conns": "lock:_conns_lock",
                "_latest_weights": "lock:_weights_lock",
                "_latest_payload": "lock:_weights_lock",
                "_latest_crc": "lock:_weights_lock",
                "_publish_seq": "lock:_weights_lock",
                "dropped": "lock:_roll_cond",
                "bad_payloads": "learner",
                "_rollout_totals": "learner",
            },
        ),
    },
    "dotaclient_tpu_torch/serve/engine.py": {
        # The serving plane: reader threads submit, ONE batcher thread
        # owns every carry/staging/params mutation (weight swaps and slot
        # zeroes are marshalled to it through latest-wins/pending sets),
        # the weight-swap thread only parks host trees. A reader touching
        # the carry store, a swap landing mid-dispatch, a reply raced past
        # its connection's death: the map machine-checks those shapes.
        "ServeEngine": ClassMap(
            default_thread="client",   # submit/release/stop: caller side
            methods={
                "_batch_loop": "batcher",
                "_apply_pending_weights": "batcher",
                "_collect_window": "batcher",
                "_dispatch_window": "batcher",
                # the port's staging of a window's rows, called by
                # _dispatch_window
                "_stage": "batcher",
                # the parity probe replays the batcher's dispatch on the
                # batcher's data: valid only with the server quiesced, so
                # it is held to the batcher's discipline
                "reference_step": "batcher",
            },
            attrs={
                "_pending": "lock:_cond",
                "_reset_slots": "lock:_cond",
                "_stopped": "lock:_cond",
                "_pending_weights": "lock:_weights_lock",
                # THE carry-residency hazard: dispatches write the store's
                # rows in place on the card, so only the batcher, which
                # issued them, may ever touch it (slot zeroes marshal
                # through _reset_slots, never direct writes)
                "_carries": "batcher",
                "_params": "batcher",
                "_lanes": "batcher",
                "_slots_np": "batcher",
                "_reset_np": "batcher",
                "_dispatch_idx": "batcher",
                # latched int: written by the batcher at swap commit, read
                # by attach frames; one-dispatch-stale reads are the design
                "_version": "any",
                # utilization accountant: window_wait/dispatch/reply
                # intervals and folds all happen on the batcher
                "_util": "batcher",
            },
        ),
    },
    "dotaclient_tpu_torch/serve/server.py": {
        "PolicyServer": ClassMap(
            default_thread="learner",   # construct/attach/close: owner side
            methods={
                "_accept_loop": "accept",
                "_reader_loop": "reader",
                "_poison": "reader",
                "_make_reply": "reader",
                "_writer_loop": "writer",
                # the weights-subscription poller (attach_weights_source)
                "loop": "weights",
                # torn down from readers, writers, and close alike; touches
                # only lock-guarded state and the conn's own cond
                "_drop": "any",
                "_publish_conn_gauges": "any",
            },
            attrs={
                "_conns": "lock:_conns_lock",
                "_free_slots": "lock:_conns_lock",
                "_weights_thread": "learner",
            },
            # the port sets the pool's gauges inside the critical section
            # that changed the pool
            holds={"_publish_conn_gauges": ("_conns_lock",)},
        ),
    },
    "dotaclient_tpu_torch/utils/tracing.py": {
        # The trace writer: any pipeline thread enqueues (lock-free,
        # GIL-atomic deque append), ONE writer thread owns the file. The
        # first "quick fix" that writes the file from a producer thread
        # trips this pass, not a code review.
        "TraceWriter": ClassMap(
            default_thread="producer",
            methods={
                "_run": "writer",
                # close() joins the writer before touching the file; the
                # post-join access is waived at the line
                "close": "any",
            },
            attrs={
                # the file handle is the writer's alone
                "_f": "writer",
                # bounded deque: append (producers) and popleft (writer)
                # are each GIL-atomic; no lock by design
                "_queue": "any",
                # latched stop flag: single bool write, stale reads fine
                "_stopped": "any",
            },
        ),
    },
    "dotaclient_tpu_torch/utils/fleet.py": {
        # The fleet health plane's three-way split: INGEST runs on
        # transport reader threads (socket) or the learner's consume
        # thread (shm drain) and may only park decoded snapshots in the
        # locked inbox; the MERGE/ROLLUP/ALERT state (per-peer tables and
        # the alert engine's rule state) belongs to the aggregator's own
        # thread alone; everything else reads through the thread-safe
        # telemetry registry.
        "FleetAggregator": ClassMap(
            default_thread="learner",   # construct/start/stop: owner side
            methods={
                "ingest": "reader",
                "_run": "agg",
                "tick": "agg",
                "_merge": "agg",
                "_rollup": "agg",
                # the reference's _peer_counter/_peer_gauge/_peer_metric
                # are one helper in the port
                "_peer_metric": "agg",
            },
            attrs={
                "_inbox": "lock:_lock",
                "_peers": "agg",
                "_engine": "agg",
                "_thread": "learner",
                # registered by the learner BEFORE start() and only read
                # by the aggregator thread afterwards (handoff by start)
                "_tick_hooks": "any",
            },
        ),
    },
    "dotaclient_tpu_torch/outcome/aggregator.py": {
        # tick() has MODAL callers: the fleet aggregator's thread in the
        # external modes, the train thread at log boundaries in the
        # in-process modes; so the window state is lock-guarded rather
        # than thread-owned
        "OutcomeAggregator": ClassMap(
            default_thread="any",
            attrs={
                "_samples": "lock:_lock",
                "_armed": "lock:_lock",
                "_last_total_eps": "lock:_lock",
                "_last_episode_t": "lock:_lock",
            },
            holds={"_publish": ("_lock",), "_total_eps": ("_lock",)},
        ),
    },
    "dotaclient_tpu_torch/utils/utilization.py": {
        # an accountant is owned by exactly the thread that constructed
        # it: the train thread (LearnerUtilization), an actor pool's step
        # loop, or serve's batcher (PoolUtilization); no locks by design,
        # so folding a pool's accountant from another thread trips this
        # pass
        "PhaseAccountant": ClassMap(
            default_thread="owner",
            attrs={
                "_acc": "owner",
                "_window_start": "owner",
            },
        ),
        "LearnerUtilization": ClassMap(
            default_thread="owner",
            attrs={
                "_last_step": "owner",
                "_ema_v": "owner",
                "_baseline_v": "owner",
                "_windows": "owner",
            },
        ),
        "PoolUtilization": ClassMap(
            default_thread="owner",
            attrs={"_last_fold": "owner"},
        ),
    },
    "dotaclient_tpu_torch/transport/shm_transport.py": {
        # single consumer by design: every method runs on the learner
        # thread (no background threads in the shm server; liveness is the
        # pid beacon, not a thread); the first thread added here trips the
        # pass instead of a review
        "ShmTransportServer": ClassMap(
            default_thread="learner",
            attrs={
                "_consumed": "learner",
                "_next_ring": "learner",
                "_last_telemetry": "learner",
                "_bad_streak": "learner",
                "_quarantined": "learner",
                "_rollout_totals": "learner",
                "_closed": "learner",
            },
        ),
    },
}


def _with_lock_stack(
    node: ast.With, lock_prefix: str = "self."
) -> List[str]:
    """Lock attr names a With statement acquires (``with self._lock:`` →
    ["_lock"])."""
    out = []
    for item in node.items:
        name = dotted_name(item.context_expr)
        if name and name.startswith(lock_prefix):
            out.append(name[len(lock_prefix):])
    return out


class _ClassScanner:
    def __init__(
        self, rel: str, cls: ast.ClassDef, cmap: ClassMap, rule_id: str
    ) -> None:
        self.rel = rel
        self.cls = cls
        self.cmap = cmap
        self.rule_id = rule_id
        self.out: List[Diagnostic] = []

    def scan(self) -> List[Diagnostic]:
        for stmt in self.cls.body:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                if stmt.name == "__init__":
                    continue  # construction: the object is not shared yet
                self._scan_def(stmt, def_stack=[stmt.name], locks=[])
        return self.out

    def _thread_of(self, def_stack: List[str]) -> str:
        for name in reversed(def_stack):
            if name in self.cmap.methods:
                return self.cmap.methods[name]
        return self.cmap.default_thread

    def _scan_def(
        self,
        node: ast.AST,
        def_stack: List[str],
        locks: List[str],
    ) -> None:
        held = list(locks)
        for outer_name in def_stack:
            held.extend(self.cmap.holds.get(outer_name, ()))
        for child in ast.iter_child_nodes(node):
            self._visit(child, def_stack, held)

    def _visit(
        self, node: ast.AST, def_stack: List[str], locks: List[str]
    ) -> None:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            self._scan_def(node, def_stack + [node.name], locks)
            return
        if isinstance(node, ast.With):
            inner = locks + _with_lock_stack(node)
            for child in ast.iter_child_nodes(node):
                self._visit(child, def_stack, inner)
            return
        if (
            isinstance(node, ast.Attribute)
            and isinstance(node.value, ast.Name)
            and node.value.id == "self"
        ):
            self._check_access(node, def_stack, locks)
        for child in ast.iter_child_nodes(node):
            self._visit(child, def_stack, locks)

    def _check_access(
        self, node: ast.Attribute, def_stack: List[str], locks: List[str]
    ) -> None:
        spec = self.cmap.attrs.get(node.attr)
        if spec is None or spec == "any":
            return
        method = def_stack[-1]
        if spec.startswith("lock:"):
            lock = spec[5:]
            if lock in locks:
                return
            self.out.append(
                Diagnostic(
                    self.rel,
                    node.lineno,
                    self.rule_id,
                    f"'{self.cls.name}.{node.attr}' accessed in "
                    f"{method}() outside 'with self.{lock}:' — the "
                    f"ownership map (lint/ownership.py) declares it "
                    f"lock-guarded; acquire the lock, list the method "
                    f"under holds=, or waive with a why",
                    context=f"{self.cls.name}.{method}.{node.attr}",
                )
            )
            return
        thread = self._thread_of(def_stack)
        if thread == spec:
            return
        self.out.append(
            Diagnostic(
                self.rel,
                node.lineno,
                self.rule_id,
                f"'{self.cls.name}.{node.attr}' is owned by the "
                f"{spec} thread but {method}() runs on the "
                f"{thread} thread (ownership map, lint/ownership.py) — "
                f"marshal through the owner, add a lock, or waive with "
                f"a why",
                context=f"{self.cls.name}.{method}.{node.attr}",
            )
        )


def scan_source_with_map(
    rel: str, source: str, class_maps: Dict[str, ClassMap],
    rule_id: str = "thread-ownership",
) -> List[Diagnostic]:
    """Scan one module against an explicit map (the unit-test surface —
    fixtures inject race-shaped snippets with a matching map)."""
    tree = ast.parse(source, rel)
    out: List[Diagnostic] = []
    for node in ast.walk(tree):
        if isinstance(node, ast.ClassDef) and node.name in class_maps:
            out.extend(
                _ClassScanner(
                    rel, node, class_maps[node.name], rule_id
                ).scan()
            )
    return out


class ThreadOwnershipRule(Rule):
    id = "thread-ownership"
    summary = (
        "shared attributes are touched only by their owning thread or "
        "under their declared lock"
    )

    def paths(self) -> Iterable[str]:
        return sorted(OWNERSHIP)

    def check(self, files: Dict[str, FileCtx]) -> List[Diagnostic]:
        out: List[Diagnostic] = []
        for rel in sorted(OWNERSHIP):
            ctx = files.get(rel)
            if ctx is None:
                continue
            out.extend(
                scan_source_with_map(rel, ctx.source, OWNERSHIP[rel], self.id)
            )
        return out
