"""The port's trace plane against the JAX package's.

* Records and blobs: ``record_to_blob`` (padded and not) gives the JAX
  package's bytes for the same record; each side's ``parse_blob`` reads the
  other's blobs; garbage parses to None on both.
* The wire: a JAX-encoded traced chunk drained by the port's
  ``decode_drained_payloads`` gets ``recv`` and ``consume``; a port-encoded
  one decodes in the JAX package with its blob intact; a traced weights
  frame crosses both ways; both port transports stamp ``recv`` on
  ``tracing.now``'s clock, before ``consume``.
* The ring: the port's and the JAX package's give the same records with
  the same ``admit`` and ``gather`` hops for the same traced rows, and an
  untraced row or a device chunk clears its slot's record.
* The vec learner in process stamps ``dispatch`` and emits the whole
  timeline; with tracing off the hot sites run no tracing code.
* Serve: a JAX client gets ``recv`` and ``reply`` from the port's server,
  a port client from the JAX server, and each emits ``done``.
* The CLIs: a port learner CLI fed by a port actor CLI over the socket,
  both with ``--trace-jsonl``, leave logs that ``scripts/trace_report.py``
  joins into full timelines, and ``utils/trace_report.py`` gives the same
  JSON on them.

Strings and ints compare exactly; timestamps only for order.
"""

import json
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from dotaclient_tpu.buffer import TrajectoryBuffer as JaxTrajectoryBuffer
from dotaclient_tpu.parallel import make_mesh
from dotaclient_tpu.protos import dota_pb2 as jpb
from dotaclient_tpu.serve import PolicyServer as JaxPolicyServer
from dotaclient_tpu.serve import ServeClient as JaxServeClient
from dotaclient_tpu.serve import ServeEngine as JaxServeEngine
from dotaclient_tpu.serve import make_inference_policy as jax_inference_policy
from dotaclient_tpu.transport import serialize as J
from dotaclient_tpu.utils import telemetry as jtel
from dotaclient_tpu.utils import tracing as jtracing
from dotaclient_tpu_torch.actor.vec_runtime import VecActorPool
from dotaclient_tpu_torch.buffer import TrajectoryBuffer
from dotaclient_tpu_torch.models import convert
from dotaclient_tpu_torch.protos import dota_pb2 as pb
from dotaclient_tpu_torch.serve import ServeClient
from dotaclient_tpu_torch.train import learner as plearner
from dotaclient_tpu_torch.transport import serialize as S
from dotaclient_tpu_torch.transport.shm_transport import ShmTransport, ShmTransportServer
from dotaclient_tpu_torch.transport.socket_transport import SocketTransport, TransportServer
from dotaclient_tpu_torch.utils import telemetry, trace_report, tracing
from tests.test_torch_buffered import buffered_configs, chunk, telemetry_registry
from tests.test_torch_common import flax_params
from tests.test_torch_external import rows_of, vec_config
from tests.test_torch_server import configs as serve_configs
from tests.test_torch_server import port_stack, stream

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WAIT_S = 30.0
PIPELINE = ("collect", "encode", "recv", "consume", "admit", "gather", "dispatch")


@pytest.fixture(autouse=True)
def no_tracer_left():
    """Each test starts and ends with both packages' tracers off."""
    tracing.shutdown()
    jtracing.shutdown()
    yield
    tracing.shutdown()
    jtracing.shutdown()


def read_events(path):
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def names(record):
    return [h[0] for h in record["hops"]]


def stamps(record):
    return [h[1] for h in record["hops"]]


def in_order(record):
    return stamps(record) == sorted(stamps(record))


def share_one_clock(monkeypatch):
    """Both packages' trace clocks on one epoch offset for the rest of the
    test. Each module fixes ``_EPOCH_OFFSET`` (wall minus monotonic) when it
    is imported; two imports minutes apart on a host whose wall clock is
    slewed in between differ by milliseconds, and a cross-package timeline
    in one process (a client's ``encode`` and the server's ``recv`` well
    under a millisecond apart) would then read out of order. Across
    processes both packages rely on wall clocks alike. The port's module
    takes the reference's offset; the reference's is only read."""
    monkeypatch.setattr(tracing, "_EPOCH_OFFSET", jtracing._EPOCH_OFFSET)


# -- records and blobs ------------------------------------------------------------------------------------------

RECORDS = [
    {"tid": "1f2e-3-a", "pid": 7983, "actor": 3, "wv": 12, "hops": [["collect", 1792264526.911951],
                                                                     ["encode", 1792264526.969002]]},
    {"tid": "w1f2e-c", "pid": 7982, "actor": -1, "wv": 12, "hops": [["publish", 1792264519.4043667]]},
    {"tid": "abc-0-1", "pid": 1, "actor": 0, "wv": 0, "hops": []},
    {"tid": "5-ffff-ff", "pid": 4194304, "actor": 65535, "wv": 2 ** 40,
     "hops": [[h, 1700000000.0 + 0.001234567 * i] for i, h in enumerate(PIPELINE)]},
]


@pytest.mark.parametrize("pad", [True, False])
@pytest.mark.parametrize("k", range(len(RECORDS)))
def test_blob_bytes_are_the_reference_and_parse_both_ways(k, pad):
    rec = RECORDS[k]
    blob = tracing.record_to_blob(rec, pad=pad)
    assert blob == jtracing.record_to_blob(rec, pad=pad)
    if pad:
        assert len(blob) >= tracing.TRACE_WIRE_LEN == jtracing.TRACE_WIRE_LEN == 192
    # %.6f stamps: both parsers read both packages' blobs to the same record
    want = jtracing.parse_blob(blob)
    assert tracing.parse_blob(blob) == want
    assert jtracing.parse_blob(tracing.record_to_blob(rec, pad=pad)) == want
    assert [h[0] for h in want["hops"]] == names(rec)
    np.testing.assert_allclose(stamps(want), stamps(rec), rtol=0, atol=1e-6)


@pytest.mark.parametrize("garbage", [
    b"", b"\x00\xff" * 40, b"tid=x pid=notanint actor=0 wv=0", b"pid=1 actor=2 wv=3", b"h encode 1.0",
    b"tid=x pid=1 actor=2 wv=3\nh encode notafloat", None, 12345, b"tid=x pid=1 actor=2\nh encode 1.0",
])
def test_garbage_parses_to_none_on_both_sides(garbage):
    assert tracing.parse_blob(garbage) is None and jtracing.parse_blob(garbage) is None


def test_weights_record_and_serve_recv_stamp():
    rec = tracing.weights_record(9)
    assert rec["tid"] == f"w{os.getpid():x}-9" and rec["actor"] == -1 and names(rec) == ["publish"]
    jrec = jtracing.weights_record(9)
    assert {k: v for k, v in rec.items() if k != "hops"} == {k: v for k, v in jrec.items() if k != "hops"}
    meta = {"trace_blob": tracing.record_to_blob(tracing.append_hop(tracing.new_record("t", 2, 3), "encode"),
                                                 pad=False)}
    got = tracing.stamp_serve_recv(meta)
    assert got is meta["trace"] and names(got) == ["encode", "recv"] and in_order(got)
    assert tracing.stamp_serve_recv({"trace_blob": b"junk"}) is None


def test_writer_counts_drops_and_writes_whole_lines(tmp_path):
    reg = telemetry.Registry()
    tracer = tracing.configure(str(tmp_path / "t.jsonl"), sample_n=3, registry=reg)
    assert tracing.get() is tracer and [tracer.should_sample() for _ in range(6)] == [False, False, True] * 2
    tracer._writer._stopped = True   # a closed writer takes nothing
    tracer.emit("lost")
    tracer._writer._stopped = False
    for i in range(5):
        tracer.emit("dispatch", step=i)
    tracer.emit_chunk(RECORDS[3])
    tracing.shutdown()
    assert tracing.get() is None
    events = read_events(tmp_path / "t.jsonl")
    assert [e["event"] for e in events] == ["dispatch"] * 5 + ["chunk"]
    assert events[-1]["origin_pid"] == RECORDS[3]["pid"] and events[-1]["hops"] == RECORDS[3]["hops"]
    snap = reg.snapshot()
    assert snap["trace/emitted_total"] == 6.0 and snap["trace/dropped_total"] == 0.0
    writer = tracing.TraceWriter(str(tmp_path / "u.jsonl"), registry=reg)
    writer.MAX_QUEUE = 0   # a writer that fell behind drops new events, counted
    writer.enqueue({"event": "x"})
    writer.close()
    assert reg.snapshot()["trace/dropped_total"] == 1.0


# -- the wire ---------------------------------------------------------------------------------------------------


def traced_row(pcfg, seed=1):
    meta, arrays = rows_of(chunk(pcfg, 1, seed), [4])[0]
    rec = tracing.append_hop(tracing.new_record("7-1-2", 1, 4), "collect")
    tracing.append_hop(rec, "encode")
    return meta, arrays, rec


def test_jax_chunk_gets_recv_and_consume_in_the_port_drain(tmp_path):
    _, pcfg = buffered_configs()
    meta, arrays, rec = traced_row(pcfg)
    blob = jtracing.record_to_blob(rec)
    payload = J.encode_rollout(arrays, **meta, trace=blob).SerializeToString()
    tracing.configure(str(tmp_path / "t.jsonl"), sample_n=1)
    totals = [0, 0]
    recv_ts = tracing.now()
    out, bad = S.decode_drained_payloads([(recv_ts, payload), payload], telemetry.Registry(), totals)
    assert bad == 0 and len(out) == 2
    for (m, _), want_recv in zip(out, (True, False)):
        assert m["trace_blob"] == blob and m["trace"]["tid"] == rec["tid"]
        assert names(m["trace"]) == ["collect", "encode"] + ["recv"] * want_recv + ["consume"]
        assert in_order(m["trace"])
    assert out[0][0]["trace"]["hops"][2][1] == recv_ts
    # a port-encoded traced chunk decodes in the JAX package with its blob
    port_payload = S.encode_rollout_bytes(arrays, **meta, trace=tracing.record_to_blob(rec))
    jmeta, _ = J.decode_rollout_bytes(port_payload, native=False)
    assert jmeta["trace_blob"] == blob
    jmeta_native, _ = J.decode_rollout_bytes(port_payload)
    assert bytes(jmeta_native["trace_blob"]) == blob


def test_untracing_drain_leaves_the_blob_unread():
    _, pcfg = buffered_configs()
    meta, arrays, rec = traced_row(pcfg)
    payload = S.encode_rollout_bytes(arrays, **meta, trace=tracing.record_to_blob(rec))
    (m, _), = S.decode_drained_payloads([(1.0, payload)], telemetry.Registry(), [0, 0])[0]
    assert "trace" not in m and tracing.parse_blob(m["trace_blob"]) == tracing.parse_blob(
        tracing.record_to_blob(rec))


@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
def test_traced_weights_frame_crosses_both_ways(direction):
    jcfg, _ = buffered_configs()
    params = flax_params(jcfg, seed=3)
    blob = tracing.record_to_blob(tracing.weights_record(11), pad=False)
    if direction == "port_to_jax":
        msg = jpb.ModelWeights.FromString(S.encode_weights(params, 11, trace=blob).SerializeToString())
        assert J.weights_trace(msg) == blob
        version, tree = J.decode_weights(msg)
    else:
        msg = pb.ModelWeights.FromString(J.encode_weights(params, 11, trace=blob).SerializeToString())
        assert S.weights_trace(msg) == blob
        version, tree = S.decode_weights(msg)
    assert version == 11 and "__trace__" not in S.flatten_tree(tree)
    assert S.weights_trace(pb.ModelWeights.FromString(S.encode_weights(params, 11).SerializeToString())) is None


@pytest.mark.parametrize("lane", ["socket", "shm"])
def test_transports_stamp_recv_on_the_trace_clock(lane, tmp_path):
    """An actor's traced chunk through each port transport: the drain's
    ``recv`` sits between the actor's ``encode`` and the decode's
    ``consume`` on the one clock of ``tracing.now``."""
    _, pcfg = buffered_configs()
    meta, arrays, rec = traced_row(pcfg, seed=2)
    tracing.configure(str(tmp_path / "t.jsonl"), sample_n=1)
    if lane == "socket":
        server = TransportServer("127.0.0.1", 0)
        client = SocketTransport(*server.address)
    else:
        server = ShmTransportServer(name=f"t-trace-{os.getpid()}", slots=2, ring_bytes=1 << 16,
                                    weights_bytes=1 << 16)
        client = ShmTransport(server.address)
    try:
        deadline = time.time() + WAIT_S
        while lane == "socket" and server.n_connected < 1 and time.time() < deadline:
            time.sleep(0.01)
        client.publish_rollout_bytes(S.encode_rollout_bytes(arrays, **meta, trace=tracing.record_to_blob(rec)))
        got = []
        while not got and time.time() < deadline:
            got = server.consume_decoded(4, timeout=0.1)
        (m, _), = got
        assert names(m["trace"]) == ["collect", "encode", "recv", "consume"] and in_order(m["trace"])
    finally:
        client.close()
        server.close()


# -- the ring and the learner ------------------------------------------------------------------------------------


def test_ring_records_match_jax_and_untraced_rows_clear_their_slots(tmp_path):
    jcfg, pcfg = buffered_configs(T=3, batch=4, capacity=8, min_fill=4)
    tracing.configure(str(tmp_path / "p.jsonl"), sample_n=1)
    jtracing.configure(str(tmp_path / "j.jsonl"), sample_n=1)
    pbuf = TrajectoryBuffer(pcfg, device="cpu", registry=telemetry.Registry())
    jbuf = JaxTrajectoryBuffer(jcfg, make_mesh(jcfg.mesh), registry=telemetry_registry())

    def rows(seed, traced, n=4):
        out = rows_of(chunk(pcfg, n, seed), [0] * n)
        for i, (m, _) in enumerate(out):
            if traced[i]:
                m["trace"] = {"tid": f"{seed}-{i}", "pid": 1, "actor": i, "wv": 0, "hops": [["encode", 1.0]]}
        return out

    def copied(batch_rows):
        """The same rows with their own records: the rings stamp in place."""
        out = []
        for m, a in batch_rows:
            m = dict(m)
            if "trace" in m:
                m["trace"] = {**m["trace"], "hops": [list(h) for h in m["trace"]["hops"]]}
            out.append((m, a))
        return out

    def both(batch_rows):
        got = []
        for buf, rs in ((pbuf, batch_rows), (jbuf, copied(batch_rows))):
            assert buf.add(rs, 0) == len(rs)
            assert buf.take(current_version=0) is not None
            got.append(buf.drain_traces())
        return got

    p, j = both(rows(1, [True, False, True, True]))
    assert [r["tid"] for r in p] == [r["tid"] for r in j] == ["1-0", "1-2", "1-3"]
    for rp, rj in zip(p, j):
        assert names(rp) == names(rj) == ["encode", "admit", "gather"] and in_order(rp)
    assert pbuf.drain_traces() == [] == jbuf.drain_traces()
    # traced rows evicted by untraced ones (the ring overflows) leave no
    # record behind: the next take of those slots drains nothing
    assert pbuf.add(rows(2, [True] * 8, n=8), 0) == 8
    assert pbuf.add(rows(3, [False] * 8, n=8), 0) == 8
    assert pbuf.take(current_version=0) is not None and pbuf.take(current_version=0) is not None
    assert pbuf.drain_traces() == []
    # a device chunk clears the slots it writes too
    assert pbuf.add(rows(4, [True] * 8, n=8), 0) == 8
    pbuf.add_device(S.unflatten_tree({k: torch.from_numpy(np.asarray(v))
                                      for k, v in S.flatten_tree(chunk(pcfg, 8, 5)).items()}), 0)
    while pbuf.take(current_version=0) is not None:
        pass
    assert pbuf.drain_traces() == []
    # and a restore: restored slots carry no live record
    assert pbuf.add(rows(6, [True] * 4), 0) == 4
    pbuf.load_state_dict(pbuf.state_dict())
    assert pbuf._slot_trace == [None] * 8
    assert pbuf.take(current_version=0) is not None and pbuf.drain_traces() == []


def test_vec_learner_emits_whole_timelines_in_process(tmp_path):
    path = str(tmp_path / "learner.jsonl")
    tracing.configure(path, sample_n=1)
    learner = plearner.Learner(vec_config(), actor="vec", device="cpu", registry=telemetry.Registry())
    try:
        assert learner._tracer is tracing.get() and learner.host_pool._tracer is tracing.get()
        learner.train(2, refresh_every=1)
    finally:
        learner.close()
    tracing.shutdown()
    events = read_events(path)
    whole = [e for e in events if e["event"] == "chunk" and "dispatch" in names(e)]
    assert whole, [e["event"] for e in events]
    for e in whole:
        # in process there is no wire: no recv, no consume
        assert names(e) == ["collect", "encode", "admit", "gather", "dispatch"] and in_order(e)
    assert {e["event"] for e in events} >= {"chunk", "dispatch"}


def test_tracing_off_runs_no_tracing_code(monkeypatch):
    """With no tracer, each hot site is one pointer test: every tracing
    function is made to raise, and the drain, the ring, the vec pool (in
    process and onto a transport) and the learner still run."""
    assert tracing.get() is None
    for name in ("now", "new_record", "append_hop", "record_to_blob", "parse_blob", "stamp_wire_hops",
                 "stamp_serve_recv", "weights_record"):
        monkeypatch.setattr(tracing, name, lambda *a, _n=name, **k: pytest.fail(f"tracing.{_n} ran"))
    _, pcfg = buffered_configs()
    meta, arrays = rows_of(chunk(pcfg, 1, 1), [0])[0]
    payload = S.encode_rollout_bytes(arrays, **meta, trace=b"tid=a pid=1 actor=0 wv=0")
    (m, _), = S.decode_drained_payloads([(1.0, payload)], telemetry.Registry(), [0, 0])[0]
    assert "trace" not in m
    buf = TrajectoryBuffer(pcfg, device="cpu", registry=telemetry.Registry())
    assert buf._tracer is None and buf._slot_trace is None
    buf.add(rows_of(chunk(pcfg, 4, 2), [0] * 4), 0)
    assert buf.take(current_version=0) is not None and buf.drain_traces() == []
    learner = plearner.Learner(vec_config(), actor="vec", device="cpu", registry=telemetry.Registry())
    try:
        assert learner._tracer is None and learner.host_pool._chunk_start is None
        learner.train(2, refresh_every=1)
    finally:
        learner.close()
    sent = []
    pool = VecActorPool(vec_config(), learner.policy, learner._actor_params_copy(), device="cpu",
                        transport=type("T", (), {"publish_rollout_bytes": lambda self, b: sent.append(b),
                                                 "latest_weights": lambda self: None})(),
                        registry=telemetry.Registry())
    pool.run(6, refresh_every=2)
    assert sent and all("trace_blob" not in S.decode_rollout_bytes(b)[0] for b in sent)


# -- serve ------------------------------------------------------------------------------------------------------


def jax_client_on_port_server(tmp_path):
    """A JAX client steps 3 requests on the port's server, both tracing
    every request; returns (the client's ``chunk`` records, the server's
    events)."""
    jcfg, pcfg = serve_configs()
    jpath, ppath = str(tmp_path / "client.jsonl"), str(tmp_path / "server.jsonl")
    jtracing.configure(jpath, sample_n=1)
    tracing.configure(ppath, sample_n=1)
    rows = stream(pcfg, 3, seed=30)
    with port_stack(pcfg, convert(flax_params(jcfg, seed=4, value_head=False))) as (_, _, server):
        client = JaxServeClient(*server.address, jcfg, timeout_s=10.0)
        try:
            for t, row in enumerate(rows):
                client.step(row, reset=t == 0)
        finally:
            client.close()
    jtracing.shutdown()
    tracing.shutdown()
    return [e for e in read_events(jpath) if e["event"] == "chunk"], read_events(ppath)


def test_jax_client_gets_recv_and_reply_from_the_port_server(tmp_path, monkeypatch):
    share_one_clock(monkeypatch)
    done, served = jax_client_on_port_server(tmp_path)
    assert len(done) == 3
    for e in done:
        assert names(e) == ["encode", "recv", "reply", "done"] and in_order(e)
    assert sorted(e["tid"] for e in served if e["event"] == "serve_request") == sorted(e["tid"] for e in done)


@pytest.mark.parametrize("skew_s", [-0.003, 0.003])
def test_skewed_trace_clocks_order_once_shared(tmp_path, monkeypatch, skew_s):
    """The port's clock set a few ms off the reference's, as two imports
    apart on a slewed host leave them: the skew shows in ``now``, and once
    the two share one offset the cross-package timeline orders again."""
    monkeypatch.setattr(tracing, "_EPOCH_OFFSET", jtracing._EPOCH_OFFSET + skew_s)
    assert abs(tracing.now() - jtracing.now() - skew_s) < 1e-3
    share_one_clock(monkeypatch)
    assert abs(tracing.now() - jtracing.now()) < 1e-3
    done, _ = jax_client_on_port_server(tmp_path)
    assert len(done) == 3
    for e in done:
        assert names(e) == ["encode", "recv", "reply", "done"] and in_order(e)


def test_port_client_gets_recv_and_reply_from_a_jax_server(tmp_path, monkeypatch):
    share_one_clock(monkeypatch)
    jcfg, pcfg = serve_configs()
    jpath, ppath = str(tmp_path / "server.jsonl"), str(tmp_path / "client.jsonl")
    jtracing.configure(jpath, sample_n=1)
    tracing.configure(ppath, sample_n=2)
    reg = jtel.Registry()
    engine = JaxServeEngine(jcfg, jax_inference_policy(jcfg), flax_params(jcfg, seed=5, value_head=False),
                            version=2, registry=reg)
    server = JaxPolicyServer(engine, jcfg, port=0, registry=reg)
    try:
        client = ServeClient(*server.address, pcfg, timeout_s=10.0)
        try:
            for t, row in enumerate(stream(pcfg, 4, seed=31)):
                client.step(row, reset=t == 0)
        finally:
            client.close()
    finally:
        server.close()
        engine.stop()
    tracing.shutdown()
    jtracing.shutdown()
    done = [e for e in read_events(ppath) if e["event"] == "chunk"]
    assert len(done) == 2   # every second request sampled
    for e in done:
        assert names(e) == ["encode", "recv", "reply", "done"] and in_order(e)
    report = trace_report.build_report([ppath, jpath])
    assert report["serve"]["rtt_s"]["n"] == 2 and report["chunks_seen"] == 0


# -- the CLIs ---------------------------------------------------------------------------------------------------


def test_traced_learner_and_actor_clis_join_in_both_reports(tmp_path):
    """A port learner CLI (socket lane, ``--smoke``, 3 steps) fed by one port
    actor CLI, both tracing every chunk: the script's report
    joins full ordered timelines from the two logs, the port's report
    gives the same JSON, and the learner's record counts no drop."""
    env = {**os.environ, "PYTHONPATH": ROOT, "JAX_PLATFORMS": "cpu"}
    with __import__("socket").socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    run = tmp_path / "run"
    run.mkdir()
    learner = subprocess.Popen(
        [sys.executable, "-m", "dotaclient_tpu_torch.train.learner", "--smoke", "--device", "cpu", "--transport",
         "socket", "--listen", f"127.0.0.1:{port}", "--steps", "3", "--refresh-every", "1", "--trace-jsonl",
         str(run / "learner.jsonl"), "--trace-sample", "1", "--metrics-jsonl", str(tmp_path / "record.jsonl")],
        cwd=str(tmp_path), env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    actor = None
    try:
        actor = subprocess.Popen(
            [sys.executable, "-m", "dotaclient_tpu_torch.actor", "--connect", f"127.0.0.1:{port}", "--n-envs", "4",
             "--rollout-len", "8", "--platform", "cpu", "--trace-jsonl", str(run / "actor.jsonl"), "--trace-sample",
             "1", "--max-reconnects", "8"],
            cwd=str(tmp_path), env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        out, _ = learner.communicate(timeout=240)
        assert learner.returncode == 0, out[-3000:]
        actor.send_signal(signal.SIGTERM)   # the graceful stop: its log drained and closed
        actor.wait(timeout=60)
    finally:
        for proc in (learner, actor):
            if proc is not None and proc.poll() is None:
                proc.kill()
                proc.wait()
    script = subprocess.run([sys.executable, os.path.join(ROOT, "scripts", "trace_report.py"), "--json", str(run)],
                            capture_output=True, text=True, timeout=120, env=env)
    assert script.returncode == 0, script.stderr[-2000:]
    want = json.loads(script.stdout.splitlines()[-1].split(" ", 1)[1])
    assert want["chunks_complete"] >= 1 and want["lines_skipped"] == 0
    assert json.loads(json.dumps(trace_report.build_report([str(run)]))) == want
    chunks = trace_report.merge_chunks(trace_report.load_events([str(run)])[0])
    whole = [c for c in chunks.values() if all(h in c["hops"] for h in PIPELINE)]
    assert whole and all([c["hops"][h] for h in PIPELINE] == sorted(c["hops"][h] for h in PIPELINE) for c in whole)
    assert want["staleness"]["applies_seen"] >= 1 and want["staleness"]["publishes_seen"] >= 1
    with open(tmp_path / "record.jsonl") as f:
        last = [json.loads(line) for line in f if line.strip()][-1]
    scalars = last.get("scalars", last)
    assert scalars["trace/dropped_total"] == 0.0 and scalars["trace/emitted_total"] > 0
