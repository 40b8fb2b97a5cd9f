"""The port's serving tier, in process: protocol, deterministic batching,
the arm-time config, the staging memo and the padded-batch bit identity,
held where they compute against the JAX package's serve path on the CPU.

The determinism contract (as ``tests/test_serve.py`` pins it for the JAX
package):

* the same arrival schedule and knobs give identical batch compositions
  (:class:`MicroBatcher` on a virtual clock);
* a request's row is bit-identical whatever batch it rode in, at
  positions 0 and 1 (fixed-capacity padding, lane-independent solve);
* a NaN lane is quarantined without moving its batch-mate's bits;
* a served row equals the JAX package's ``solve_batch`` row for the same
  lane at 1e-12 scale-relative with identical iterations, and the port's
  ``sweep_designs`` row likewise.
"""
import socket
import struct

import numpy as np
import pytest
import torch

from raft_tpu_torch.build.buckets import BucketSig
from raft_tpu_torch.cli import DESIGNS
from raft_tpu_torch.serve import protocol
from raft_tpu_torch.serve.batcher import Lane, MicroBatcher
from raft_tpu_torch.serve.config import ServeConfig
from raft_tpu_torch.serve.solver import SolverCore, design_key, solve_batch, solve_solo

OC3 = str(DESIGNS / "OC3spar.yaml")
OC4 = str(DESIGNS / "OC4semi.yaml")
VOLT = str(DESIGNS / "VolturnUS-S.yaml")
#: the JAX fixture's size: nw = 8 physical bins (16 padded), capacity 3
SIZE = dict(nw=8, w_min=0.3, w_max=2.1, n_iter=8)


# --------------------------------------------------------------------------
# protocol: framing and request validation
# --------------------------------------------------------------------------
def test_protocol_frame_round_trip():
    a, b = socket.socketpair()
    try:
        msg = {"op": "ping", "id": "x", "payload": list(range(50))}
        protocol.send_msg(a, msg)
        assert protocol.recv_msg(b) == msg
    finally:
        a.close()
        b.close()


def test_protocol_frames_match_jax():
    """The port's frames are the JAX package's bytes: a client of one
    daemon speaks to the other."""
    from raft_tpu.serve import protocol as jprotocol

    msg = {"op": "solve", "id": "q1", "design": "oc3", "Hs": 6.5, "Tp": 10.25, "trace": "t-9"}
    for send, recv in ((protocol.send_msg, jprotocol.recv_msg),
                       (jprotocol.send_msg, protocol.recv_msg)):
        a, b = socket.socketpair()
        try:
            send(a, msg)
            assert recv(b) == msg
        finally:
            a.close()
            b.close()
    assert protocol.MAX_FRAME == jprotocol.MAX_FRAME
    assert protocol.OPS == jprotocol.OPS
    assert protocol.DESIGN_ALIASES == jprotocol.DESIGN_ALIASES
    assert protocol.overloaded_response("r", 50.0, "x") == \
        jprotocol.overloaded_response("r", 50.0, "x")
    e = ValueError("bad")
    assert protocol.error_response("r", e) == jprotocol.error_response("r", e)


def test_protocol_peer_close_and_oversize():
    a, b = socket.socketpair()
    a.close()
    with pytest.raises(protocol.PeerClosed):
        protocol.recv_msg(b)
    b.close()
    a, b = socket.socketpair()
    try:
        # an announced frame length past the cap refuses before reading
        a.sendall(struct.pack(">I", protocol.MAX_FRAME + 1))
        with pytest.raises(protocol.ProtocolError):
            protocol.recv_msg(b)
    finally:
        a.close()
        b.close()


def test_parse_request_kinds_and_errors():
    one = protocol.parse_request({"op": "solve", "id": "a", "design": "oc3", "Hs": 6, "Tp": 10})
    assert len(one["lanes"]) == 1
    assert one["lanes"][0][0] == OC3
    dlc = protocol.parse_request({"op": "dlc", "id": "b", "design": OC4,
                                  "cases": [[6, 10], [8, 12]]})
    assert len(dlc["lanes"]) == 2
    sw = protocol.parse_request({"op": "sweep", "id": "c", "designs": ["oc3", "volturnus"],
                                 "Hs": 7, "Tp": 11})
    assert [lane[1] for lane in sw["lanes"]] == ["OC3spar", "VolturnUS-S"]
    assert protocol.parse_request({"op": "ping"})["lanes"] == []
    for bad in (
        {"op": "nope"},
        {"op": "solve", "design": "oc3", "Hs": 6, "Tp": 10},   # no id
        {"op": "solve", "id": "x", "design": "mystery", "Hs": 6, "Tp": 10},
        {"op": "solve", "id": "x", "design": "oc3", "Hs": "wide", "Tp": 1},
        {"op": "solve", "id": "x", "design": "oc3", "Hs": float("nan"), "Tp": 1},
        {"op": "dlc", "id": "x", "design": "oc3", "cases": []},
        {"op": "dlc", "id": "x", "design": "oc3", "cases": [[1, 2, 3]]},
        {"op": "sweep", "id": "x", "designs": [], "Hs": 6, "Tp": 10},
        [1, 2],
    ):
        with pytest.raises(protocol.ProtocolError):
            protocol.parse_request(bad)


def test_parse_request_matches_jax_on_shipped_aliases():
    """Every alias resolves to the same YAML file as in the JAX package
    (one copy of the designs, read as data)."""
    import os

    from raft_tpu.serve import protocol as jprotocol

    for alias in sorted(protocol.DESIGN_ALIASES):
        path, label = protocol.resolve_design(alias)
        jpath, jlabel = jprotocol.resolve_design(alias)
        assert os.path.samefile(path, jpath) and label == jlabel
    inline = {"a": 1}
    assert protocol.resolve_design(inline) == (inline, "<inline>")


def test_parse_request_trace_passthrough():
    r = protocol.parse_request({"op": "solve", "id": "a", "design": "oc3", "Hs": 6, "Tp": 10,
                                "trace": "abc-1"})
    assert r["trace"] == "abc-1"
    r2 = protocol.parse_request({"op": "solve", "id": "a", "design": "oc3", "Hs": 6, "Tp": 10})
    assert r2["trace"] is None
    with pytest.raises(protocol.ProtocolError, match="trace"):
        protocol.parse_request({"op": "solve", "id": "a", "design": "oc3", "Hs": 6, "Tp": 10,
                                "trace": 7})


def test_design_key_dict_content_hash():
    from raft_tpu.serve.solver import design_key as jdesign_key

    d1 = {"a": 1, "b": [1, 2]}
    d2 = {"b": [1, 2], "a": 1}          # key order must not matter
    assert design_key(d1) == design_key(d2) == jdesign_key(d1)
    assert design_key(d1) != design_key({"a": 2, "b": [1, 2]})
    assert design_key("/p/x.yaml") == "/p/x.yaml"


# --------------------------------------------------------------------------
# micro-batcher: deterministic deadline/capacity composition
# --------------------------------------------------------------------------
class VirtualClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


SIG_A = BucketSig(16, 64, 32)
SIG_B = BucketSig(48, 128, 32)


def _lane(i):
    return Lane(request_id=i, seq=0, label=f"l{i}", staged=None)


def _run_schedule(events, deadline=10.0, cap=3, batcher=MicroBatcher, lane=_lane):
    """Replay [(t, sig, lane_id) ...] arrivals plus ('advance', t) steps on
    a virtual clock; after each step drain every closeable batch.  Returns
    the closed compositions [(sig, [lane ids]) ...]."""
    clk = VirtualClock()
    mb = batcher(batch_deadline_s=deadline, batch_max=cap, clock=clk)
    out = []

    def drain_ready():
        while True:
            got = mb.next_batch(timeout=0.0)
            if got is None:
                return
            out.append((tuple(got[0]), [ln.request_id for ln in got[1]]))

    for ev in events:
        if ev[0] == "advance":
            clk.t = ev[1]
        else:
            t, sig, lid = ev
            clk.t = t
            mb.submit(sig, lane(lid))
        drain_ready()
    return out


def test_batcher_capacity_close_fifo_and_remainder():
    events = [(0.0, SIG_A, i) for i in range(5)]     # cap 3: one close
    got = _run_schedule(events, deadline=100.0, cap=3)
    assert got == [(tuple(SIG_A), [0, 1, 2])]
    # the remainder keeps its original arrival: the deadline runs from 0
    got2 = _run_schedule(events + [("advance", 100.0)], deadline=100.0, cap=3)
    assert got2 == [(tuple(SIG_A), [0, 1, 2]), (tuple(SIG_A), [3, 4])]


def test_batcher_deadline_close():
    events = [(0.0, SIG_A, 0), (2.0, SIG_A, 1), ("advance", 9.9)]
    assert _run_schedule(events, deadline=10.0) == []   # not yet
    events += [("advance", 10.0)]
    assert _run_schedule(events, deadline=10.0) == [(tuple(SIG_A), [0, 1])]


def test_batcher_mixed_bucket_interleave_deterministic():
    events = [
        (0.0, SIG_A, 0), (1.0, SIG_B, 1), (2.0, SIG_A, 2),
        (3.0, SIG_B, 3), (4.0, SIG_A, 4),          # A capacity-closes
        (5.0, SIG_B, 5), ("advance", 11.5),        # B deadline-closes
        (12.0, SIG_A, 6), ("advance", 30.0),
    ]
    expect = [
        (tuple(SIG_A), [0, 2, 4]),
        (tuple(SIG_B), [1, 3, 5]),
        (tuple(SIG_A), [6]),
    ]
    runs = [_run_schedule(events, deadline=10.0, cap=3) for _ in range(3)]
    assert runs[0] == expect
    assert runs[1] == runs[0] and runs[2] == runs[0]


def test_batcher_compositions_match_jax():
    """The same arrival schedule closes the same batches in both
    packages (the JAX batcher is fed the same bucket tuples)."""
    from raft_tpu.serve.batcher import Lane as JLane
    from raft_tpu.serve.batcher import MicroBatcher as JMicroBatcher

    rng = np.random.default_rng(7)
    t = np.cumsum(rng.uniform(0.0, 4.0, size=40))
    sigs = [SIG_A, SIG_B]
    events = [(float(ti), sigs[int(rng.integers(0, 2))], i) for i, ti in enumerate(t)]
    events.append(("advance", float(t[-1]) + 50.0))
    for cap in (1, 3, 5):
        ours = _run_schedule(events, deadline=6.0, cap=cap)
        theirs = _run_schedule(events, deadline=6.0, cap=cap, batcher=JMicroBatcher,
                               lane=lambda i: JLane(request_id=i, seq=0, label="", staged=None))
        assert ours == theirs and sum(len(b) for _, b in ours) == 40


def test_batcher_simultaneous_deadlines_tie_break_stable():
    events = [(0.0, SIG_B, 0), (0.0, SIG_A, 1), ("advance", 10.0)]
    got = _run_schedule(events, deadline=10.0)
    assert got == [(tuple(SIG_A), [1]), (tuple(SIG_B), [0])]


def test_batcher_close_drains_then_signals_exit():
    clk = VirtualClock()
    mb = MicroBatcher(batch_deadline_s=100.0, batch_max=8, clock=clk)
    mb.submit(SIG_A, _lane(0))
    mb.submit(SIG_B, _lane(1))
    mb.close()
    sigs = {tuple(mb.next_batch()[0]) for _ in range(2)}
    assert sigs == {tuple(SIG_A), tuple(SIG_B)}
    assert mb.next_batch() is None
    with pytest.raises(RuntimeError):
        mb.submit(SIG_A, _lane(2))
    assert mb.counters() == {"submitted": 2, "popped": 2, "pending": 0}


def test_batcher_refresh_knobs_wake_and_validate():
    clk = VirtualClock()
    mb = MicroBatcher(batch_deadline_s=100.0, batch_max=4, clock=clk)
    for i in range(2):
        mb.submit(SIG_A, _lane(i))
    assert mb.next_batch(timeout=0.0) is None
    mb.set_batch_max(2)                  # now capacity-closeable
    assert [ln.request_id for ln in mb.next_batch(timeout=0.0)[1]] == [0, 1]
    mb.submit(SIG_A, _lane(2))
    mb.set_deadline(0.0)
    assert mb.next_batch(timeout=0.0)[1][0].request_id == 2
    with pytest.raises(ValueError):
        mb.set_batch_max(0)
    assert mb.depth() == {}


# --------------------------------------------------------------------------
# config snapshot: environment read once, at arm time
# --------------------------------------------------------------------------
def test_config_from_env_snapshot(monkeypatch):
    monkeypatch.setenv("RAFT_TPU_SERVE_BATCH_DEADLINE_MS", "40")
    monkeypatch.setenv("RAFT_TPU_SERVE_BATCH_MAX", "5")
    monkeypatch.setenv("RAFT_TPU_SERVE_SOCKET", "/tmp/x.sock")
    cfg = ServeConfig.from_env(nw=8)
    assert (cfg.batch_deadline_s, cfg.batch_max, cfg.socket_path,
            cfg.nw) == (0.040, 5, "/tmp/x.sock", 8)
    # a mid-process env change must not reach the snapshot
    monkeypatch.setenv("RAFT_TPU_SERVE_BATCH_MAX", "99")
    assert cfg.batch_max == 5
    assert ServeConfig.from_env(batch_max=2).batch_max == 2
    monkeypatch.setenv("RAFT_TPU_SERVE_BATCH_MAX", "zero")
    with pytest.raises(ValueError):
        ServeConfig.from_env()
    monkeypatch.setenv("RAFT_TPU_SERVE_BATCH_MAX", "0")
    with pytest.raises(ValueError):
        ServeConfig.from_env()


def test_config_defaults_match_jax_and_socket_is_the_ports(monkeypatch):
    import dataclasses

    from raft_tpu.serve.config import ServeConfig as JServeConfig

    for k in ("RAFT_TPU_SERVE_BATCH_DEADLINE_MS", "RAFT_TPU_SERVE_BATCH_MAX",
              "RAFT_TPU_SERVE_SOCKET"):
        monkeypatch.delenv(k, raising=False)
    ours, theirs = ServeConfig.from_env(), JServeConfig.from_env()
    for f in dataclasses.fields(JServeConfig):
        if f.name != "socket_path":
            assert getattr(ours, f.name) == getattr(theirs, f.name), f.name
    assert ours.socket_path != theirs.socket_path
    assert "raft_tpu_torch_serve_" in ours.socket_path
    assert ours.device is None and ours.dtype == torch.float64


# --------------------------------------------------------------------------
# solver: staging memo, padded-batch bit identity, parity
# --------------------------------------------------------------------------
@pytest.fixture(scope="module")
def core3():
    """One warm SolverCore shared by the solver tests (the JAX fixture's
    size: nw 8 -> 16 padded, 8 iterations, capacity 3), on the CPU."""
    cfg = ServeConfig(batch_deadline_s=0.01, batch_max=3, escalate=False, device="cpu", **SIZE)
    return SolverCore(cfg)


@pytest.fixture(scope="module")
def jcore3():
    from raft_tpu.serve.config import ServeConfig as JServeConfig
    from raft_tpu.serve.solver import SolverCore as JSolverCore

    return JSolverCore(JServeConfig(batch_deadline_s=0.01, batch_max=3, escalate=False, **SIZE))


def _mk_lane(core, design, Hs, Tp, rid="r", lane_cls=Lane):
    sig, staged = core.stage_lane(design, Hs, Tp)
    return sig, lane_cls(request_id=rid, seq=0, label=str(rid), staged=staged)


def test_stage_lane_memo_and_routing(core3):
    sig_a, st = core3.stage_lane(OC3, 6.0, 10.0)
    sig_a2, st2 = core3.stage_lane(OC3, 6.0, 10.0)
    assert st is st2, "repeated (design, sea state) must hit the memo"
    sig_b, _ = core3.stage_lane(OC4, 6.0, 10.0)
    assert sig_a == sig_a2
    assert sig_a != sig_b, "OC3 and OC4 must route to different buckets"
    # a different sea state is a different staging in the same bucket
    sig_a3, st3 = core3.stage_lane(OC3, 7.0, 11.0)
    assert sig_a3 == sig_a and st3 is not st
    members, rna, env, wave, C_moor = st
    assert members.seg_rA.device.type == "cpu" and members.seg_rA.dtype == torch.float64
    assert env.Hs.ndim == 0 and float(env.Hs) == 6.0 and float(env.Tp) == 10.0
    assert wave.zeta.shape == (sig_a.nw,) and C_moor.shape == (6, 6)


def test_stage_lane_single_flight(core3, monkeypatch):
    """Two readers asking for the same cold lane stage it once."""
    import threading
    import time

    calls = []
    real = core3._stage

    def slow(*args):
        calls.append(args)
        time.sleep(0.2)
        return real(*args)

    monkeypatch.setattr(core3, "_stage", slow)
    out = []
    threads = [threading.Thread(target=lambda: out.append(core3.stage_lane(OC3, 6.25, 10.5)))
               for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    assert len(calls) == 1 and len(out) == 4
    assert all(o[1] is out[0][1] for o in out)


def test_concurrent_staging_matches_serial():
    """Readers stage different lanes at once (the mooring stiffness is a
    forward-mode Jacobian, whose AD levels PyTorch numbers process-wide):
    every lane equals its serial staging bit for bit."""
    import threading

    from raft_tpu_torch.mooring import system

    cfg = ServeConfig(batch_max=3, escalate=False, device="cpu", **SIZE)
    lanes = [(d, 6.0 + 0.5 * i, 10.0 + i) for i, d in enumerate([OC3, OC4, VOLT] * 2)]
    serial = [SolverCore(cfg).stage_lane(*lane)[1][4] for lane in lanes]
    core = SolverCore(cfg)
    out, errors = [None] * len(lanes), []

    def run(i):
        try:
            out[i] = core.stage_lane(*lanes[i])[1][4]
        except Exception as e:          # surfaced below
            errors.append(repr(e))

    threads = [threading.Thread(target=run, args=(i,)) for i in range(len(lanes))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    assert not errors, errors
    assert all(torch.equal(a, b) for a, b in zip(out, serial))
    assert not system._JACFWD_LOCK._is_owned()


def test_stage_lane_matches_solo_staging(core3):
    """A served lane is the solo staging of the same design: the shared
    device half gives the same tensors as stage_design_base with the
    bucket pinned."""
    from raft_tpu_torch.model import stage_design_base

    sig, (members, rna, env, wave, C_moor) = core3.stage_lane(VOLT, 7.0, 11.0)
    _d, m2, rna2, env2, wave2, C2 = stage_design_base(
        VOLT, Hs=7.0, Tp=11.0, bucket=sig, device="cpu", **{k: SIZE[k] for k in
                                                           ("nw", "w_min", "w_max")})
    assert torch.equal(members.node_r, m2.node_r) and torch.equal(C_moor, C2)
    assert torch.equal(wave.zeta, wave2.zeta) and torch.equal(wave.k, wave2.k)
    assert float(rna.mRNA) == rna2.mRNA and float(env.depth) == env2.depth


def test_solve_batch_rows_and_occupancy(core3):
    sig, lane = _mk_lane(core3, OC3, 6.0, 10.0)
    rows, info = solve_batch(core3, sig, [lane])
    assert len(rows) == 1
    r = rows[0]
    assert r["converged"] and r["finite"] and not r["quarantined"]
    assert len(r["std_dev"]) == 6 and np.isfinite(r["std_dev"]).all()
    assert info["lanes"] == 1 and info["capacity"] == 3
    assert info["occupancy"] == pytest.approx(1 / 3)


def test_lane_results_batch_composition_independent(core3):
    """The serving determinism pin: one lane's row is bit-identical solo
    (padded with copies of itself) and in mixed company at positions 0
    and 1."""
    sig, lane_a = _mk_lane(core3, OC3, 6.0, 10.0, "a")
    solo_rows, _ = solve_batch(core3, sig, [lane_a])
    _, lane_b = _mk_lane(core3, OC3, 7.5, 11.0, "b")
    _, lane_c = _mk_lane(core3, OC3, 9.0, 12.5, "c")
    mixed_rows, info = solve_batch(core3, sig, [lane_a, lane_b, lane_c])
    assert info["occupancy"] == 1.0
    assert mixed_rows[0]["std_dev"] == solo_rows[0]["std_dev"], \
        "batch-mates changed a lane's bits"
    assert mixed_rows[0]["iterations"] == solo_rows[0]["iterations"]
    assert mixed_rows[1]["std_dev"] != mixed_rows[0]["std_dev"]
    # position 1 among strangers
    at1, _ = solve_batch(core3, sig, [lane_c, lane_a])
    assert at1[1]["std_dev"] == solo_rows[0]["std_dev"]
    solo_b, _ = solve_batch(core3, sig, [_mk_lane(core3, OC3, 7.5, 11.0)[1]])
    assert solo_b[0]["std_dev"] == mixed_rows[1]["std_dev"]


def test_nan_lane_quarantined_mates_bitwise(core3):
    """One client's Tp = 0 lane (NaN JONSWAP spectrum) is quarantined; its
    batch-mate's bits do not move."""
    sig, good = _mk_lane(core3, OC3, 6.0, 10.0, "good")
    solo_rows, _ = solve_batch(core3, sig, [good])
    _, bad = _mk_lane(core3, OC3, 6.0, 0.0, "bad")
    rows, info = solve_batch(core3, sig, [good, bad])
    assert rows[0]["finite"] and not rows[0]["quarantined"]
    assert rows[0]["std_dev"] == solo_rows[0]["std_dev"]
    assert rows[1]["quarantined"] and not rows[1]["finite"]
    assert not rows[1]["salvaged"]          # escalate=False in core3
    assert 1 in info["quarantined_real"]


def _rel(got, want) -> float:
    got, want = np.asarray(got), np.asarray(want)
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


@pytest.mark.parametrize("alias,cases", [
    ("oc3", [(6.0, 10.0), (7.5, 11.0)]),
    ("volturnus", [(8.0, 12.0), (6.5, 10.5), (9.0, 13.0)]),
    ("oc4", [(6.0, 10.0)]),
])
def test_solve_batch_rows_match_jax(core3, jcore3, alias, cases):
    """The port's served rows against the JAX package's ``solve_batch``
    for the same lanes: 1e-12 scale-relative, identical iterations, the
    same bucket signature."""
    from raft_tpu.serve.batcher import Lane as JLane
    from raft_tpu.serve.solver import solve_batch as jsolve_batch

    design = protocol.resolve_design(alias)[0]
    lanes, jlanes = [], []
    for i, (Hs, Tp) in enumerate(cases):
        sig, lane = _mk_lane(core3, design, Hs, Tp, rid=i)
        jsig, jlane = _mk_lane(jcore3, design, Hs, Tp, rid=i, lane_cls=JLane)
        assert tuple(sig) == tuple(jsig)
        lanes.append(lane)
        jlanes.append(jlane)
    rows, info = solve_batch(core3, sig, lanes)
    jrows, jinfo = jsolve_batch(jcore3, jsig, jlanes)
    assert info["capacity"] == jinfo["capacity"] == 3
    for r, jr in zip(rows, jrows):
        assert r["iterations"] == jr["iterations"]
        assert r["converged"] == jr["converged"] and r["finite"] == jr["finite"]
        assert _rel(r["std_dev"], jr["std_dev"]) <= 1e-12


def test_solve_batch_matches_sweep_designs(core3):
    """The serve path is sweep_designs plus padding: each row matches the
    port's plain mixed-design call on the same designs at 1e-12
    scale-relative with identical iterations."""
    from raft_tpu_torch.parallel.sweep import sweep_designs

    ref = sweep_designs([OC3, OC4, VOLT], Hs=6.0, Tp=10.0, return_xi=False, device="cpu",
                        **SIZE)
    for i, design in enumerate((OC3, OC4, VOLT)):
        r = solve_solo(core3, design, 6.0, 10.0)
        assert r["iterations"] == int(ref["iterations"][i])
        assert _rel(r["std_dev"], ref["std dev"][i]) <= 1e-12


def test_quarantined_lane_goes_through_the_ladder(monkeypatch):
    """With escalation on (the daemon's default), a quarantined lane is
    handed to the escalation ladder and reported unsalvaged (a Tp = 0
    lane stays NaN on every rung); its batch-mate's bits do not move."""
    from raft_tpu_torch.resilience import ladder

    seen = []
    real = ladder.quarantine_and_salvage

    def spy(*args, **kwargs):
        seen.append(kwargs.get("escalate"))
        return real(*args, **kwargs)

    monkeypatch.setattr(ladder, "quarantine_and_salvage", spy)
    cfg = ServeConfig(batch_max=2, escalate=True, device="cpu", **SIZE)
    core = SolverCore(cfg)
    sig, good = _mk_lane(core, OC3, 6.0, 10.0, "good")
    _, bad = _mk_lane(core, OC3, 6.0, 0.0, "bad")
    rows, info = solve_batch(core, sig, [good, bad])
    assert seen == [True]
    assert rows[1]["quarantined"] and not rows[1]["salvaged"] and not rows[1]["finite"]
    assert info["quarantined_real"] == [1]
    assert rows[0]["std_dev"] == solve_batch(core, sig, [good])[0][0]["std_dev"]


def test_solver_refresh_drops_memo_and_stats(core3):
    core3.stage_lane(OC3, 6.0, 10.0)
    info = core3.refresh()
    assert info["staged_lanes_dropped"] >= 1 and info["executables_evicted"] >= 0
    _sig, st = core3.stage_lane(OC3, 6.0, 10.0)
    assert st is core3.stage_lane(OC3, 6.0, 10.0)[1]
    st = core3.stats()
    assert st["compiles"] == 0 and "kernel_builds" not in st and st["device"] == "cpu"
    assert st["batch_max"] == 3 and st["buckets"]
    core3.reset_stats()
    assert core3.stats()["buckets"] == {}


def test_solver_core_refuses_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        SolverCore(ServeConfig(**SIZE))
