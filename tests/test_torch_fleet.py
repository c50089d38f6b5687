"""Port parity: edl_tpu_torch's serving fleet (``serving/{router,replica,
fleet}.py``, ``scheduler/autoscaler.py``'s gates) against edl_tpu's.

The routing, supervision and scaling logic runs against the reference's
kind of fakes (scripted transports; spawn/probe/drain hooks in place of
subprocesses) on both packages, which must take the same decisions and
publish the same metrics. The replica server runs over loopback HTTP with
the port's CPU engine, and ``python -m edl_tpu_torch fleet`` runs once as
subprocesses. The port repairs three faults of the reference (a
replica's "draining" refusal, a residual the router already finished,
an engine loop that starves the replica's handlers): the tests that
show them hold the reference's outcome beside the port's, or show the
port's where the reference's is a race.
"""

import dataclasses
import hashlib
import json
import os
import subprocess
import sys
import threading

import jax
import numpy as np
import pytest
import torch

from edl_tpu.models import llama as jl
from edl_tpu.obs.metrics import MetricsRegistry as JRegistry
from edl_tpu.scheduler import autoscaler as jauto
from edl_tpu.serving import fleet as jfleet
from edl_tpu.serving import router as jrouter
from edl_tpu.serving.scheduler import Request as JRequest
from edl_tpu.utils import faults as jfaults
from edl_tpu_torch.cli import main as tmain
from edl_tpu_torch.models import llama as tl
from edl_tpu_torch.models.convert import params_from_numpy
from edl_tpu_torch.obs import events as tflight
from edl_tpu_torch.obs.metrics import MetricsRegistry as TRegistry
from edl_tpu_torch.scheduler import autoscaler as tauto
from edl_tpu_torch.serving import fleet as tfleet
from edl_tpu_torch.serving import router as trouter
from edl_tpu_torch.serving.engine import ContinuousBatchingEngine
from edl_tpu_torch.serving.replica import ReplicaServer
from edl_tpu_torch.serving.scheduler import Request as TRequest
from edl_tpu_torch.utils import faults as tfaults

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TCFG = dataclasses.replace(tl.LlamaConfig.tiny(), use_flash=True)


def _chip_smoke():
    sys.path.insert(0, ROOT)
    import chip_smoke

    return chip_smoke


JP = jl.init_params(jax.random.PRNGKey(0), dataclasses.replace(
    jl.LlamaConfig.tiny(), use_flash=True))
TP = params_from_numpy(jax.tree_util.tree_map(np.asarray, JP), "cpu")

# (router module, fleet module, Request, registry, faults) of each side
PORT = (trouter, tfleet, TRequest, TRegistry, tfaults)
REF = (jrouter, jfleet, JRequest, JRegistry, jfaults)


def _fake_model(prompt, max_new):
    """Deterministic stateless greedy decode: token j depends only on
    prompt + previously generated tokens (the replay contract)."""
    seq, out = list(prompt), []
    for _ in range(max_new):
        t = (sum(seq) * 31 + len(seq)) % 211
        out.append(t)
        seq.append(t)
    return out


def _table(side, n=2, **kw):
    rt, _, _, reg, _ = side
    table = rt.ReplicaTable(registry=reg(), **kw)
    for i in range(n):
        table.add(f"r{i}", f"fake://r{i}")
        table.set_state(f"r{i}", rt.READY)
    return table


def _both(fn):
    """``fn(side)`` on the port and on the reference."""
    return fn(PORT), fn(REF)


# -- the table -----------------------------------------------------------------


def test_rendezvous_scores_are_the_references():
    for i in range(200):
        key = ",".join(str((i * 7 + k) % 97) for k in range(i % 16))
        rid = f"r{i % 5}"
        assert trouter._rendezvous_score(key, rid) == \
            jrouter._rendezvous_score(key, rid)
    want = int.from_bytes(hashlib.md5(b"1,2|r0").digest()[:8], "big")
    assert trouter._rendezvous_score("1,2", "r0") == want


def _state_walk(side):
    rt = side[0]
    table = _table(side, 3, suspect_after=2, dead_after=4)
    out = []
    for rid, ok, depth in [("r0", False, None), ("r0", False, None),
                           ("r0", True, 5), ("r1", False, None),
                           ("r0", False, None), ("r0", False, None),
                           ("r0", False, None), ("r0", False, None),
                           ("r0", True, 1), ("r2", True, 9)]:
        out.append(table.mark_probe(rid, ok, queue_depth=depth))
    table.set_state("r1", rt.DRAINING)
    out.append(table.mark_probe("r1", True))
    out.append(table.set_state("r2", rt.SUSPECT))
    out.append([vars(r) for r in table.snapshot()])
    out.append(table.ready_count())
    return out


def test_table_state_machine_matches_the_reference():
    got, want = _both(_state_walk)
    assert got == want


def _routing(side):
    rt = side[0]
    reg = side[3]()
    table = rt.ReplicaTable(registry=reg, affinity_slack=2)
    for i in range(4):
        table.add(f"r{i}", f"fake://r{i}")
        table.set_state(f"r{i}", rt.READY)
    picks = []
    for depth, rid in ((3, "r0"), (0, "r1"), (5, "r2"), (1, "r3")):
        table.mark_probe(rid, True, queue_depth=depth)
    for i in range(12):
        ref = table.acquire(session=f"s{i % 3}" if i % 2 else None,
                            prefix_key=",".join(map(str, range(i % 5))),
                            exclude=("r2",) if i % 4 == 0 else ())
        picks.append(ref.id)
        if i % 3 == 0:
            table.release(ref.id)
    table.unpin("s1", picks[1])
    picks.append(table.acquire(session="s1").id)
    table.remove("r3")
    picks.append(table.acquire(session="s0").id)
    picks.append(table.acquire(exclude=("r0", "r1", "r2")))
    return picks, reg.render()


def test_routing_picks_and_fleet_gauges_match_the_reference():
    (tp, ttext), (jp, jtext) = _both(_routing)
    assert tp == jp
    assert ttext == jtext


# -- the router ----------------------------------------------------------------


def _route(side, script, max_failovers=2, **req_kw):
    """One request through a router whose transport follows ``script``
    (one action a forward): "done", "requeued", "reject", "drop@k" (k
    tokens escape, then the wire dies)."""
    rt, _, request, reg_cls, _ = side
    table = _table(side, 3)
    reg = reg_cls()
    calls = []

    def transport(ref, payload, on_tokens):
        act = script[min(len(calls), len(script) - 1)]
        calls.append((ref.id, payload["max_new"], len(payload["prompt"])))
        toks = _fake_model(payload["prompt"], payload["max_new"])
        if act.startswith("drop@"):
            on_tokens(toks[:int(act[5:])])
            raise ConnectionError("replica gone mid-stream")
        if act == "reject":
            raise rt.RouteRejected("over_capacity", "queue full")
        if act == "requeued":
            return "requeued"
        on_tokens(toks)
        return "done"

    router = rt.Router(table, transport=transport, registry=reg,
                       max_failovers=max_failovers, backoff_base_s=0.0,
                       sleep=lambda s: None)
    res = router.generate(request(rid="x", prompt=[3, 1, 4, 1, 5],
                                  max_new=8, **req_kw))
    return vars(res), calls, [vars(r) for r in table.snapshot()], \
        reg.render()


@pytest.mark.parametrize("script,max_failovers", [
    (["done"], 2), (["drop@3", "done"], 2), (["drop@2", "drop@1", "done"], 2),
    (["drop@1"], 1), (["drop@0"], 0), (["reject"], 2),
    (["requeued", "done"], 0), (["requeued", "drop@4", "done"], 1),
])
def test_failover_budget_and_replay_match_the_reference(script,
                                                        max_failovers):
    got, want = _both(lambda side: _route(side, script, max_failovers))
    assert got == want
    res = got[0]
    if res["outcome"] == "done":
        assert res["tokens"] == _fake_model([3, 1, 4, 1, 5], 8)


def test_deadline_without_replicas_times_out_as_the_reference():
    def run(side):
        rt, _, request, reg_cls, _ = side
        clk = {"t": 0.0}

        def clock():
            clk["t"] += 0.5
            return clk["t"]

        router = rt.Router(rt.ReplicaTable(registry=reg_cls()),
                           transport=lambda *a: "done", registry=reg_cls(),
                           pick_wait_s=10.0, clock=clock,
                           sleep=lambda s: None)
        return vars(router.generate(
            request(rid="x", prompt=[1], max_new=2, deadline_s=2.0)))

    got, want = _both(run)
    assert got == want and got["outcome"] == "timeout"


def test_router_forward_fault_site_fails_over_as_the_reference():
    def run(side):
        rt, _, request, reg_cls, flt = side
        served = []

        def transport(ref, payload, on_tokens):
            served.append(ref.id)
            on_tokens(_fake_model(payload["prompt"], payload["max_new"]))
            return "done"

        router = rt.Router(_table(side, 2), transport=transport,
                           registry=reg_cls(), backoff_base_s=0.0,
                           sleep=lambda s: None)
        flt.arm("router.forward:drop@n=1", seed=0)
        try:
            res = router.generate(request(rid="x", prompt=[5], max_new=3))
            fired = flt.counts().get("router.forward")
        finally:
            flt.disarm()
        return vars(res), served, fired

    got, want = _both(run)
    assert got == want and got[0]["failovers"] == 1 and got[2] == 1


def test_draining_refusal_reroutes_where_the_reference_gives_up():
    """A replica that began draining between the route and the forward
    refuses with reason "draining" before admitting anything. The
    reference ends the request "rejected:draining" (a rolling swap under
    traffic then fails); the port re-routes it whole, with no failover."""
    def run(side):
        rt = side[0]
        calls = []

        def transport(ref, payload, on_tokens):
            calls.append(ref.id)
            if len(calls) == 1:
                raise rt.RouteRejected("draining", "replica draining")
            on_tokens(_fake_model(payload["prompt"], payload["max_new"]))
            return "done"

        router = rt.Router(_table(side, 2), transport=transport,
                           registry=side[3](), max_failovers=0)
        return vars(router.generate(side[2](rid="x", prompt=[2, 7],
                                            max_new=5))), calls

    (got, gcalls), (want, wcalls) = _both(run)
    assert want["outcome"] == "rejected:draining" and len(wcalls) == 1
    assert got["outcome"] == "done" and got["failovers"] == 0
    assert got["tokens"] == _fake_model([2, 7], 5)
    assert len(gcalls) == 2 and gcalls[0] != gcalls[1]


# -- the supervisor --------------------------------------------------------------


class _FakeFleetEnv:
    """Shared state behind the supervisor's spawn/probe/drain fakes."""

    def __init__(self, fleet_mod):
        self.fleet = fleet_mod
        self.health, self.residual, self.drained = {}, {}, []

    def spawn_fn(self, rid, gen):
        url = f"fake://{rid}"
        self.health[url] = {"status": "ok", "queue_depth": 0}
        return self.fleet.ReplicaHandle(id=rid, generation=gen, url=url)

    def probe_fn(self, url):
        doc = self.health[url]
        if isinstance(doc, Exception):
            raise doc
        return dict(doc)

    def drain_fn(self, url):
        self.drained.append(url)
        return {"residual": self.residual.get(url, []), "served": 1}


def _supervisor(side, n=2, **kw):
    rt, fl, _, reg_cls, _ = side
    env = _FakeFleetEnv(fl)
    table = rt.ReplicaTable(registry=reg_cls())
    kw.setdefault("sleep", lambda s: None)
    sup = fl.ReplicaSupervisor(table, spawn_fn=env.spawn_fn,
                               probe_fn=env.probe_fn,
                               drain_fn=env.drain_fn, **kw)
    for _ in range(n):
        sup.wait_ready(sup.spawn())
    sup._target = n
    return env, sup, table


def _ids_states(table):
    return sorted((r.id, r.state, r.generation) for r in table.snapshot())


def test_death_respawn_and_reaping_match_the_reference():
    def run(side):
        env, sup, table = _supervisor(side)
        env.health["fake://r0"] = ConnectionError("kill -9")
        states = [sup.probe_once("r0") for _ in range(3)]
        after_death = _ids_states(table)
        # the router walks r1 to DEAD between sweeps; the prober reaps it
        for _ in range(table.dead_after):
            table.mark_probe("r1", ok=False)
        reaped = sup.probe_once("r1")
        return states, after_death, reaped, _ids_states(table)

    got, want = _both(run)
    assert got == want
    assert got[0][-1] == "dead" and len(got[-1]) == 2


def test_drain_before_evict_matches_the_reference():
    def run(side):
        rt, fl, _, reg_cls, _ = side
        env, sup, table = _supervisor(side)
        env.residual["fake://r0"] = [
            {"rid": "leftover", "prompt": [4, 2], "max_new": 3}]
        served = []

        def transport(ref, payload, on_tokens):
            served.append((ref.id, payload["rid"]))
            on_tokens(_fake_model(payload["prompt"], payload["max_new"]))
            return "done"

        fleet = fl.ServingFleet(sup, rt.Router(table, transport=transport,
                                               registry=reg_cls()))
        done = fleet.scale_down(victim="r0")
        return ([vars(r) for r in done], env.drained, served,
                _ids_states(table), sup.target)

    got, want = _both(run)
    assert got == want
    assert got[0][0]["tokens"] == _fake_model([4, 2], 3)


@pytest.mark.parametrize("n", [2, 3])
def test_rolling_swap_holds_the_ready_floor_as_the_reference(n):
    def run(side):
        rt, fl, _, reg_cls, _ = side
        env, sup, table = _supervisor(side, n)
        env.residual["fake://r1"] = [
            {"rid": "displaced", "prompt": [9], "max_new": 2}]
        served = []

        def transport(ref, payload, on_tokens):
            served.append((ref.id, payload["rid"]))
            on_tokens(_fake_model(payload["prompt"], payload["max_new"]))
            return "done"

        fleet = fl.ServingFleet(sup, rt.Router(table, transport=transport,
                                               registry=reg_cls()))
        gen = fleet.rolling_swap()
        return (gen, sup.min_ready_observed, _ids_states(table), served,
                {k: vars(v) for k, v in fleet.results.items()})

    got, want = _both(run)
    assert got == want
    assert got[1] == n - 1


def test_a_finished_residual_runs_once_where_the_reference_reruns_it():
    """A drain residual whose request a generate() call already finished
    (re-routed by the router while the victim was evicted): the
    reference runs it a second time, the port does not."""
    def run(side):
        rt, fl, request, reg_cls, _ = side
        env, sup, table = _supervisor(side)
        served = []

        def transport(ref, payload, on_tokens):
            served.append(payload["rid"])
            on_tokens(_fake_model(payload["prompt"], payload["max_new"]))
            return "done"

        fleet = fl.ServingFleet(sup, rt.Router(table, transport=transport,
                                               registry=reg_cls()))
        fleet.generate(request(rid="q", prompt=[9], max_new=2))
        fleet._requeue_docs([{"rid": "q", "prompt": [9], "max_new": 2}])
        return served

    got, want = _both(run)
    assert want == ["q", "q"]
    assert got == ["q"]


def test_spawn_and_health_fault_sites_match_the_reference():
    def run(side):
        rt, fl, _, reg_cls, flt = side
        env = _FakeFleetEnv(fl)
        table = rt.ReplicaTable(registry=reg_cls(), suspect_after=1,
                                dead_after=3)
        sup = fl.ReplicaSupervisor(table, spawn_fn=env.spawn_fn,
                                   probe_fn=env.probe_fn,
                                   drain_fn=env.drain_fn, spawn_retries=1,
                                   sleep=lambda s: None)
        flt.arm("replica.spawn:raise@n=1", seed=0)
        try:
            rid = sup.spawn()
            sup.wait_ready(rid)
        finally:
            flt.disarm()
        flt.arm("replica.health:raise@every=1,max=2", seed=0)
        try:
            states = [sup.probe_once(rid) for _ in range(3)]
        finally:
            flt.disarm()
        flt.arm("replica.spawn:raise@every=1", seed=0)
        try:
            with pytest.raises(RuntimeError, match="failed to spawn"):
                sup.spawn()
        finally:
            flt.disarm()
        return states, _ids_states(table)

    got, want = _both(run)
    assert got == want and got[0] == ["suspect", "suspect", "ready"]


# -- the scaler -------------------------------------------------------------------


class _FakeScalableFleet:
    def __init__(self):
        self.actions = []

    def scale_up(self):
        self.actions.append("up")

    def scale_down(self):
        self.actions.append("down")


def test_scaler_thresholds_cooldown_and_slo_bypass_match_the_reference():
    def run(side):
        rt, fl = side[0], side[1]
        table = _table(side, 2)
        clk = {"t": 0.0}
        ttft = {"p95": 0.01}
        scaler = fl.FleetScaler(
            table, min_replicas=1, max_replicas=3, depth_high=4.0,
            depth_low=0.5, cooldown_s=30.0, ttft_slo_s=0.2,
            ttft_p95_s=lambda: ttft["p95"], clock=lambda: clk["t"])
        fleet = _FakeScalableFleet()
        out = []
        for t, depth, p95 in ((0, 6, 0.01), (5, 6, 0.01), (31, 6, 0.01),
                              (40, 0, 0.01), (62, 0, 0.01), (63, 0, 0.9),
                              (64, 2, 0.9), (65, 9, 0.01), (100, 2, 0.01)):
            clk["t"] = float(t)
            ttft["p95"] = p95
            for rid in table.ids():
                table.mark_probe(rid, ok=True, queue_depth=depth)
            out.append((scaler.decide(), scaler.tick(fleet)))
        return out, fleet.actions

    got, want = _both(run)
    assert got == want
    assert "up" in got[1] and "down" in got[1]


def test_gates_match_the_references():
    for gate_mod in (tauto, jauto):
        with pytest.raises(ValueError):
            gate_mod.HysteresisGate(-1.0)

    def run(mod):
        clk = {"t": 0.0}
        urgent = {"v": False}
        gate = mod.ScaleGate("k", 10.0, clock=lambda: clk["t"],
                             bypass=lambda: urgent["v"])
        acts = []
        out = []
        for t, decision, u in ((0, "up", False), (3, "up", False),
                               (4, None, False), (5, "down", True),
                               (12, "down", False), (16, "up", False)):
            clk["t"] = float(t)
            urgent["v"] = u
            out.append(gate.apply(lambda: decision, acts.append))
        undamped = mod.HysteresisGate(0.0)
        return out, acts, undamped.ready("x")

    assert run(tauto) == run(jauto)


# -- the replica over HTTP, with the port's engine --------------------------------


class _PausedEngine(ContinuousBatchingEngine):
    """The port's engine whose loop can be held (``paused``) and which
    signals each submit — so the drain test orders its steps by events."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.paused = threading.Event()
        self.submitted = threading.Event()

    @property
    def has_work(self):
        return not self.paused.is_set() and super().has_work

    def submit(self, *a, **kw):
        super().submit(*a, **kw)
        self.submitted.set()


def _engine(**kw):
    return _PausedEngine(TP, TCFG, max_slots=2, max_len=64, horizon=4,
                         device="cpu", **kw)


def test_replica_streams_the_engines_tokens_and_reports_health():
    want_eng = ContinuousBatchingEngine(TP, TCFG, max_slots=2, max_len=64,
                                        horizon=4, device="cpu")
    prompts = {"a": [1, 2, 3], "b": [7, 7, 7, 7, 7, 9]}
    for rid, p in prompts.items():
        want_eng.submit(rid, p, 11)
    want = {k: v.tokens for k, v in want_eng.run().items()}
    with ReplicaServer(_engine(), generation=7,
                       registry=TRegistry()) as srv:
        hz = trouter.http_json(srv.url, "/healthz")
        assert hz["status"] == "ok" and hz["generation"] == 7
        assert hz["queue_depth"] == 0 and hz["active_slots"] == 0
        table = trouter.ReplicaTable(registry=TRegistry())
        table.add("r0", srv.url)
        table.set_state("r0", trouter.READY)
        router = trouter.Router(table, registry=TRegistry())
        got = {}
        threads = [threading.Thread(target=lambda rid=rid, p=p: got.update(
            {rid: router.generate(TRequest(rid=rid, prompt=p, max_new=11))}))
            for rid, p in prompts.items()]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert {k: v.tokens for k, v in got.items()} == want
        assert all(v.outcome == "done" for v in got.values())
        assert trouter.http_json(srv.url, "/healthz")["results"] == 2


def test_replica_drain_requeues_an_attached_stream_to_another_replica():
    """A request queued on a replica whose loop is held gets displaced by
    /drain; its attached router stream ends "requeued" and the same
    router call finishes it on the second replica, exactly once. Every
    step is ordered by an event, none by a sleep."""
    held, live = _engine(), _engine()
    held.paused.set()
    with ReplicaServer(held, registry=TRegistry()) as s0, \
            ReplicaServer(live, registry=TRegistry()) as s1:
        table = trouter.ReplicaTable(registry=TRegistry())
        table.add("r0", s0.url)
        table.add("r1", s1.url)
        table.set_state("r0", trouter.READY)
        router = trouter.Router(table, registry=TRegistry())
        out = {}
        t = threading.Thread(target=lambda: out.setdefault(
            "res", router.generate(
                TRequest(rid="moved", prompt=[6, 6], max_new=3))))
        t.start()
        assert held.submitted.wait(timeout=30), "request never reached r0"
        # r1 joins before the drain, so the re-route finds it READY
        table.set_state("r1", trouter.READY)
        table.set_state("r0", trouter.DRAINING)
        doc = trouter.http_json(s0.url, "/drain", body={})
        assert [d["rid"] for d in doc["residual"]] == ["moved"]
        t.join(timeout=60)
        assert not t.is_alive()
        res = out["res"]
        assert res.outcome == "done" and res.failovers == 0
        assert live.results["moved"].tokens == res.tokens
        assert held.results["moved"].outcome == "requeued"
        with pytest.raises(trouter.RouteRejected) as e:
            trouter.HttpTransport()(
                trouter.ReplicaRef(id="r0", url=s0.url),
                {"rid": "late", "prompt": [1], "max_new": 1},
                lambda toks: None)
        assert e.value.reason == "draining"
    kinds = [r["kind"] for r in tflight.default_recorder().records()]
    assert "router.requeue" in kinds


# -- the verb -------------------------------------------------------------------------


def test_replica_spec_command_is_the_references_on_the_port():
    kw = dict(workdir="/w", slots=3, max_len=80, horizon=2, max_new_cap=9,
              block_size=16, seed=5, export_dir="/e", extra=["--x"])
    got = tfleet.ReplicaSpec(device="cpu", **kw).command("r3", "/p", 2)
    want = jfleet.ReplicaSpec(**kw).command("r3", "/p", 2)
    assert got[:3] == [sys.executable, "-m", "edl_tpu_torch"]
    assert want[:3] == [sys.executable, "-m", "edl_tpu.cli"]
    i = got.index("--device")
    assert got[i:i + 2] == ["--device", "cpu"]
    assert got[3:i] + got[i + 2:] == want[3:]
    assert tfleet.ReplicaSpec(workdir="/w").device == "cuda"


@pytest.mark.parametrize("argv", [
    ["fleet", "--dryrun", "--warm-from", "p2p", "--warm-addr", "h:1"],
    ["fleet", "--replica", "--dryrun", "--warm-from", "p2p"],
])
def test_fleet_warm_from_p2p_is_not_ported_yet(argv, capsys):
    assert tmain(argv) == 1
    assert "not ported yet" in capsys.readouterr().err


def test_fleet_verb_swaps_under_traffic_on_the_cpu(tmp_path):
    out = subprocess.run(
        [sys.executable, "-m", "edl_tpu_torch", "fleet", "--dryrun",
         "--device", "cpu", "--replicas", "2", "--requests", "6", "--swap",
         "--workdir", str(tmp_path)],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=ROOT))
    assert out.returncode == 0, out.stderr[-3000:]
    report = json.loads(out.stdout.strip().splitlines()[-1])
    assert report["ok"] is True and report["swapped"] is True
    assert report["min_ready"] >= 1 and report["outcomes"] == {"done": 6}
    logs = "".join(open(tmp_path / n).read() for n in os.listdir(tmp_path)
                   if n.endswith(".log"))
    assert logs.count("device=cpu") == 4  # two booted, two swapped in
    # each replica's boot stamps, in the order of its stages
    boots = _chip_smoke()._replica_boots(str(tmp_path))
    assert sorted(boots) == ["r0", "r1", "r2", "r3"]
    for b in boots.values():
        assert list(b) == ["main", "imports", "device", "params", "engine",
                           "bound"]
        assert list(b.values()) == sorted(b.values())


class _BusyEngine:
    """Engine double whose every step holds the engine lock for 20 ms,
    with work for ``steps`` steps."""

    def __init__(self, steps):
        self.left = steps
        self.queue = type("Q", (), {"depth": 0})()
        self.results = {}
        self._slots, self._inflight = [], []

    @property
    def active_slots(self):
        return 1 if self.left else 0

    @property
    def has_work(self):
        return self.left > 0

    def step(self):
        import time

        time.sleep(0.02)
        self.left -= 1


def test_replica_answers_health_while_its_engine_is_busy():
    """The port's engine loop hands its lock to waiting handlers between
    two steps: /healthz answers while the engine still has work (in the
    reference a busy engine starves it, and the supervisor's 3 s probes
    time out)."""
    eng = _BusyEngine(steps=150)  # 3 s of work
    with ReplicaServer(eng, registry=TRegistry()) as srv:
        seen = [trouter.http_json(srv.url, "/healthz", timeout_s=2.0)
                for _ in range(5)]
    assert all(hz["active_slots"] == 1 for hz in seen)
    assert eng.left > 0


def test_replica_metrics_report_the_processs_own_launches(monkeypatch):
    """A replica's ``/metrics`` carries its own wrapper's launch count
    (``edl_kernel_launches``, the plain forward counted as the kernel
    here), which chip_smoke reads beside its prefills: launches ==
    prefills x layers."""
    from edl_tpu_torch.obs.metrics import reset_default_registry
    from edl_tpu_torch.ops import flash_attention as tfa

    plain = tfa.flash_attention_ref

    def counting(q, k, v, causal=True, block_q=512, block_k=1024):
        tfa._launched("flash_fwd")
        return plain(q, k, v, causal, block_q, block_k)

    monkeypatch.setattr(tfa, "flash_attention_ref", counting)
    reset_default_registry()
    tflight.reset_default_recorder()
    tfa.reset_launches()
    try:
        eng = ContinuousBatchingEngine(TP, TCFG, max_slots=2, max_len=64,
                                       horizon=4, device="cpu")
        with ReplicaServer(eng) as srv:
            table = trouter.ReplicaTable(registry=TRegistry())
            table.add("r0", srv.url)
            table.set_state("r0", trouter.READY)
            router = trouter.Router(table, registry=TRegistry())
            for i in range(3):
                res = router.generate(TRequest(rid=f"m{i}", prompt=[3, i + 1],
                                               max_new=4))
                assert res.outcome == "done"
            got = _chip_smoke()._replica_counts(srv.url)
    finally:
        tfa.reset_launches()
    assert got["prefills"] == 3 and got["completed"] == 3
    assert got["launches"] == 3 * TCFG.n_layers
    _chip_smoke()._launch_check({"r0": got}, TCFG.n_layers)


def test_boot_breakdown_splits_spawn_to_ready_by_the_replicas_stamps(
        tmp_path):
    stamps = {"main": 100.5, "imports": 108.0, "device": 108.5,
              "params": 109.5, "engine": 109.75, "bound": 110.0}
    (tmp_path / "r0.log").write_text(
        "# replica r0 serving http://127.0.0.1:1 gen=0 device=cuda\n"
        f"# replica r0 boot {json.dumps(stamps)}\n")
    (tmp_path / "r1.log").write_text("a replica that never served\n")
    records = [
        {"kind": "replica.spawn", "t_wall": 100.0, "corr": {"worker": "r0"}},
        {"kind": "replica.spawn", "t_wall": 100.0, "corr": {"worker": "r1"}},
        {"kind": "serve.prefill", "t_wall": 101.0, "corr": {"rid": "x"}},
        {"kind": "replica.ready", "t_wall": 110.25, "corr": {"worker": "r0"}},
    ]
    got = _chip_smoke()._boot_breakdown(str(tmp_path), records)
    assert got == {"r0": {"main_s": 0.5, "imports_s": 7.5, "device_s": 0.5,
                          "params_s": 1.0, "engine_s": 0.25, "bound_s": 0.25,
                          "ready_s": 0.25, "total_s": 10.25}}


# -- a replica's boot: the export read in place --------------------------------


@pytest.mark.parametrize("dtype", ["bfloat16", "float32", "none"])
def test_export_leaves_read_in_place_equal_np_loads(tmp_path, dtype):
    """Leaves of an uncompressed export are memory maps of the archive
    (the copy to the card reads the page cache once); each equals
    np.load's array in dtype, shape, order and bits, and the loaded
    params own their memory."""
    from edl_tpu_torch.runtime import export

    params = {"w": torch.randn(3, 5), "ln": torch.ones(5),
              "layers": {"wq": torch.randn(2, 4, 6), "empty": torch.zeros(0),
                         "scalar": torch.tensor(2.5),
                         "ids": torch.arange(7, dtype=torch.int32)},
              "seq": [torch.arange(4), torch.randn(3, 2).t()]}
    root = str(tmp_path / "e")
    export.export_params(root, params, step=1, dtype=dtype)
    doc = export.export_status(root)
    with np.load(os.path.join(doc["_dir"], "params.npz")) as z:
        want = {k: np.array(z[k]) for k in z.files}
    got = {"/".join(p): t for p, t in export._iter_param_leaves(doc)}
    assert got.keys() == want.keys()
    for k, a in want.items():
        t = got[k]
        if doc["dtypes"].get(k) == "bfloat16":
            t = t.view(torch.uint16)
        assert t.numpy().dtype == a.dtype and t.shape == a.shape, k
        assert t.numpy().flags.f_contiguous == a.flags.f_contiguous, k
        assert np.array_equal(t.numpy(), a), k
    loaded, _ = export.load_export(root, device="cpu")
    before = {k: v.clone() for k, v in loaded.items() if k != "layers"
              and k != "seq"}
    # the archive overwritten in place: params that still mapped it
    # would change with it
    path = os.path.join(doc["_dir"], "params.npz")
    size = os.path.getsize(path)
    with open(path, "r+b") as f:
        f.write(b"\0" * size)
    for k, v in before.items():
        assert torch.equal(loaded[k], v), k


def test_compressed_export_members_fall_back_to_np_load(tmp_path):
    from edl_tpu_torch.runtime import export

    root = str(tmp_path / "e")
    export.export_params(root, {"w": torch.randn(4, 4)}, step=1,
                         dtype="float32")
    doc = export.export_status(root)
    path = os.path.join(doc["_dir"], "params.npz")
    with np.load(path) as z:
        w = np.array(z["w"])
    np.savez_compressed(path, w=w)
    (key, t), = export._iter_param_leaves(doc)
    assert key == ["w"] and not isinstance(t.numpy(), np.memmap)
    assert np.array_equal(t.numpy(), w)
