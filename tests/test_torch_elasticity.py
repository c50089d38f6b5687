"""The port's elasticity plane (``edl_tpu_torch/elasticity``) held
against the JAX package's: the lease broker's lifecycle, conservation,
epochs and refusals with the flight events and gauges they leave; the
handover controller's diurnal rows and ledger on the same script; the
``elasticity --json`` verb against the reference's; the coordinator-
fronted broker (lifecycle, fence, resync after a restart, a controller
handover) on the repo's native coordinator; and the weight push both
ways, with the port's forward on pulled weights against the JAX one.
"""

import contextlib
import dataclasses
import io
import json
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from edl_tpu.cli.main import main as ref_main
from edl_tpu.elasticity import broker as jbroker
from edl_tpu.elasticity import controller as jcontroller
from edl_tpu.elasticity import weightpush as jwp
from edl_tpu.models import llama as jl
from edl_tpu.obs import events as jflight
from edl_tpu.obs.metrics import MetricsRegistry as JRegistry
from edl_tpu.utils import faults as jfaults
from edl_tpu_torch import cli as tcli
from edl_tpu_torch.elasticity import broker as tbroker
from edl_tpu_torch.elasticity import controller as tcontroller
from edl_tpu_torch.elasticity import weightpush as twp
from edl_tpu_torch.elasticity.distbroker import DistributedChipBroker
from edl_tpu_torch.models import llama as tl
from edl_tpu_torch.obs import events as tflight
from edl_tpu_torch.obs.metrics import MetricsRegistry as TRegistry
from edl_tpu_torch.runtime import coordinator as tcoord
from edl_tpu_torch.utils import faults as tfaults

# the forward on pulled weights: test_torch_llama.py's tolerance
TOL = dict(atol=1e-4, rtol=1e-4)

SIDES = {
    "port": (tbroker, tcontroller, tflight, TRegistry, tfaults),
    "reference": (jbroker, jcontroller, jflight, JRegistry, jfaults),
}


class Clock:
    def __init__(self, t=0.0):
        self.t = t

    def __call__(self):
        return self.t


def _events(flight):
    return [(e["kind"], e["severity"], e["corr"].get("site"),
             {k: v for k, v in e["attrs"].items()})
            for e in flight.default_recorder().records()
            if e["kind"].startswith("lease.")]


def _broker_script(side):
    """The reference tests' broker cases as one script: every result,
    refusal and gauge, and the flight events they leave."""
    broker, _, flight, Registry, _ = SIDES[side]
    flight.reset_default_recorder()
    reg = Registry()
    clk = Clock()
    b = broker.ChipLeaseBroker(8, registry=reg, clock=clk)
    out = []

    def rec(fn, *a):
        try:
            r = fn(*a)
        except broker.LeaseError as e:
            r = f"LeaseError: {e}"
        except ValueError as e:
            r = f"ValueError: {e}"
        if isinstance(r, broker.Lease):
            r = dataclasses.asdict(r)
        elif isinstance(r, list):
            r = [dataclasses.asdict(x) for x in r]
        out.append((r, b.free_chips, b.epoch, b.check_conservation()))

    clk.t = 1.0
    rec(b.grant, "train:job", 6)
    rec(b.grant, "serve:r0", 3)  # the pool cannot cover it
    rec(b.grant, "serve:r0", 0)
    rec(b.free, "L0001")  # not RECALLING
    clk.t = 2.0
    rec(b.recall, "L0001")
    rec(b.recall, "L0001")  # idempotent: no second event
    rec(b.free, "L0001")
    rec(b.free, "L0001")  # idempotent repeat
    rec(b.recall, "L0001")  # already FREED
    rec(b.recall, "L9999")
    rec(b.free, "L9999")
    for i in range(3):
        clk.t = 3.0 + i
        rec(b.grant, f"serve:r{i % 2}", 2)
    rec(b.recall, "L0003")
    rec(b.holder_crashed, "serve:r0")  # GRANTED and RECALLING both return
    rec(b.holder_crashed, "serve:r0")
    rec(b.snapshot)
    rec(b.live)
    gauges = [(n, reg.get(n).value(**lab)) for n, lab in (
        ("edl_lease_chips_free", {}), ("edl_lease_epoch", {}),
        ("edl_lease_chips", {"side": "serve"}),
        ("edl_lease_chips", {"side": "train"}),
        ("edl_leases", {"state": "FREED"}),
        ("edl_leases", {"state": "GRANTED"}))]
    return out, gauges, _events(flight)


def test_the_broker_runs_the_references_script():
    got, want = _broker_script("port"), _broker_script("reference")
    assert got[0] == want[0]
    assert got[1] == want[1]
    assert got[2] == want[2]
    assert got[0][-3][0] == []  # a settled holder crashes to nothing


def test_the_broker_conserves_under_threads():
    b = tbroker.ChipLeaseBroker(16, registry=TRegistry())

    def churn(side):
        for i in range(25):
            try:
                lease = b.grant(f"{side}:h{i}", 1)
            except tbroker.LeaseError:
                continue
            b.recall(lease.lease_id)
            b.free(lease.lease_id)

    ts = [threading.Thread(target=churn, args=(s,))
          for s in ("train", "serve", "train")]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    assert b.free_chips == 16 and b.check_conservation()


def _diurnal(side, make_broker=None, hours=50, breach_at=(), fault=False):
    """The controller over fake sides through a diurnal curve (and an
    SLO breach, and a recall RPC that fails once): its rows, ledger,
    handover counter and events."""
    broker, controller, flight, Registry, faults = SIDES[side]
    flight.reset_default_recorder()
    clk = Clock()
    b = (make_broker(clk) if make_broker is not None else
         broker.ChipLeaseBroker(8, registry=Registry(), clock=clk))
    st = {"train": 6, "replicas": 1, "offered": 0.25, "breach": False}
    reg = Registry()
    ctl = controller.ElasticityController(
        b,
        controller.TrainPort(chips=lambda: st["train"],
                             apply_chips=lambda n: st.update(train=n),
                             min_chips=2),
        controller.ServePort(
            replicas=lambda: st["replicas"],
            load=lambda: st["offered"] / max(st["replicas"], 1),
            slo_breached=lambda: st["breach"],
            add_replica=lambda: st.update(replicas=st["replicas"] + 1) or 0.5,
            remove_replica=lambda: st.update(replicas=st["replicas"] - 1),
            min_replicas=1),
        chips_per_replica=2, cooldown_s=7200.0, clock=clk, registry=reg)
    ctl.bootstrap()
    if fault:
        faults.arm("lease.recall:raise@n=1,max=1")
    rows = []
    try:
        for hour in range(hours):
            clk.t = hour * 3600.0
            h = hour % 24
            st["offered"] = (6.0 if 10 <= h <= 17 else
                             2.0 if h in (8, 9, 18, 19) else 0.25)
            st["breach"] = hour in breach_at
            action = ctl.tick()
            assert b.check_conservation(), (side, hour)
            rows.append((hour, action, st["train"], st["replicas"],
                         b.free_chips, b.epoch))
    finally:
        faults.disarm()
    counter = reg.get("edl_lease_handovers_total")
    counts = {d: counter.value(direction=d) for d in ("to_serve", "to_train")}
    kinds = [(e["kind"], e["attrs"].get("direction"), e["attrs"].get("n"))
             for e in flight.default_recorder().records()
             if e["kind"].startswith(("handover.", "lease."))]
    return rows, [dataclasses.asdict(h) for h in ctl.ledger], counts, kinds


def test_the_controller_gives_the_references_rows_and_ledger():
    kw = dict(breach_at=(3,), fault=True)
    got, want = _diurnal("port", **kw), _diurnal("reference", **kw)
    assert got == want
    rows, ledger, counts, _ = got
    assert counts["to_serve"] >= 2 and counts["to_train"] >= 2
    assert any(h["recall_retries"] for h in ledger)
    assert rows[3][1] == "to_serve"  # the breach bypassed the cooldown
    with pytest.raises(ValueError, match="chips_per_replica"):
        tcontroller.ElasticityController(
            None, None, None, chips_per_replica=0)


def _stdout(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    return rc, buf.getvalue()


@pytest.mark.parametrize("argv", [
    ["elasticity", "--json"],
    ["elasticity", "--json", "--chips", "12", "--train-chips", "8",
     "--replicas", "2", "--hours", "30", "--cooldown-s", "7200"],
    ["elasticity"],
    ["elasticity", "--train-chips", "9"],
])
def test_the_elasticity_verb_prints_the_references_document(argv, capsys):
    got = _stdout(tcli.main, argv)
    want = _stdout(ref_main, argv)
    assert got == want
    if got[0]:
        assert "pool holds" in capsys.readouterr().err
    elif "--json" in argv:
        doc = json.loads(got[1])
        assert doc["conserved"] and doc["handovers"]


# -- the coordinator-fronted broker ------------------------------------------


@pytest.fixture
def coord(tmp_path):
    with tcoord.CoordinatorServer(wal_path=str(tmp_path / "wal"),
                                  lease_recover_s=0.0) as s:
        yield s


def test_the_elasticity_verb_runs_against_the_coordinator(tmp_path):
    docs = []
    for main in (tcli.main, ref_main):
        with tcoord.CoordinatorServer() as srv:
            rc, out = _stdout(main, ["elasticity", "--json", "--coordinator",
                                     f"127.0.0.1:{srv.port}"])
            assert rc == 0
            docs.append(json.loads(out))
    assert docs[0] == docs[1]
    assert docs[0] == json.loads(_stdout(tcli.main,
                                         ["elasticity", "--json"])[1])
    assert tcli.main(["elasticity", "--coordinator", "nohost"]) == 1


def test_distbroker_lifecycle_and_refusals(coord):
    tflight.reset_default_recorder()
    cl = coord.client()
    b = DistributedChipBroker(cl, 8, registry=TRegistry())
    lease = b.grant("train:job", 6)
    assert lease.state == tbroker.GRANTED and lease.epoch == 1
    assert b.free_chips == 2 and b.check_conservation()
    assert b.recall(lease.lease_id).state == tbroker.RECALLING
    assert b.recall(lease.lease_id).state == tbroker.RECALLING  # retried
    assert b.free(lease.lease_id) == 6
    assert b.free(lease.lease_id) == 0
    assert b.get(lease.lease_id).state == tbroker.FREED
    assert b.free_chips == 8
    evs = [e for e in tflight.default_recorder().records()
           if e["kind"] == "lease.recall"]
    assert len(evs) == 1
    with pytest.raises(tbroker.LeaseError, match="nochips"):
        b.grant("serve:r0", 9)
    with pytest.raises(tbroker.LeaseError, match="unknown"):
        b.recall("L9999")
    # a pool of another size is busy while leases live
    b.grant("serve:r0", 2)
    with pytest.raises(tbroker.LeaseError, match="busy"):
        DistributedChipBroker(coord.client(), 4, registry=TRegistry())
    # the lease.rpc site drops before the round trip: nothing moves
    tfaults.arm("lease.rpc:drop@n=1,max=1")
    try:
        with pytest.raises(ConnectionError):
            b.grant("train:job", 2)
    finally:
        tfaults.disarm()
    assert b.free_chips == 6 and b.check_conservation()
    assert [x.holder for x in b.live()] == ["serve:r0"]
    cl.close()


def test_distbroker_fences_a_stale_holder(coord):
    tflight.reset_default_recorder()
    reg = TRegistry()
    cl = coord.client()
    b = DistributedChipBroker(cl, 8, registry=reg)
    lease = b.grant("serve:r0", 2)
    assert b.confirm(lease.lease_id)
    with b._lock:
        b._leases[lease.lease_id].epoch = lease.epoch - 1
    assert b.confirm(lease.lease_id) is False
    evs = [e for e in tflight.default_recorder().records()
           if e["kind"] == "lease.fence"]
    assert len(evs) == 1 and evs[0]["attrs"]["reason"] == "stale_epoch"
    assert evs[0]["corr"]["site"] == "lease.confirm"
    assert reg.get("edl_lease_fenced_total").value(reason="stale_epoch") == 1
    assert b.get(lease.lease_id).state == tbroker.FREED
    # the holder-restart path: right memory passes, stale memory fences
    b2 = DistributedChipBroker(coord.client(), 8, registry=TRegistry())
    ok = b2.adopt(lease.lease_id, lease.holder, lease.chips, lease.epoch)
    assert b2.confirm(ok.lease_id)
    stale = b2.adopt(lease.lease_id, lease.holder, lease.chips,
                     lease.epoch + 7)
    assert b2.confirm(stale.lease_id) is False
    cl.close()


def test_distbroker_resyncs_after_the_coordinator_restarts(coord):
    tflight.reset_default_recorder()
    reg = TRegistry()
    b = DistributedChipBroker(coord.client(), 8, registry=reg)
    b.grant("train:job", 5)
    coord.restart()  # the WAL replays the pool; RECOVERING until confirms
    assert b.recovering
    res = b.resync()
    assert res["fenced"] == [] and not res["recovering"]
    assert b.check_conservation() and b.free_chips == 3
    evs = [e for e in tflight.default_recorder().records()
           if e["kind"] == "lease.recover"]
    assert len(evs) == 1
    assert reg.get("edl_lease_recoveries_total").value() == 1


def test_the_controller_hands_over_through_the_coordinator(coord):
    """The diurnal loop over the coordinator-fronted broker gives the
    in-process broker's rows and ledger, a recall fault included."""
    def dist(clk):
        return DistributedChipBroker(coord.client(), 8, registry=TRegistry(),
                                     clock=clk)

    got = _diurnal("port", make_broker=dist, hours=26, fault=True)
    want = _diurnal("port", hours=26, fault=True)
    assert got[:3] == want[:3]
    assert any(k == "lease.recover" for k, _, _ in got[3])


# -- the weight push ----------------------------------------------------------

JCFG = jl.LlamaConfig.tiny()


def test_the_port_pulls_the_references_push_and_forwards_like_jax():
    jp = jl.init_params(jax.random.PRNGKey(7), JCFG)
    srv = jwp.serve_params(jp, JCFG.to_meta(), step=3)
    try:
        params, doc, step = twp.fetch_params(f"127.0.0.1:{srv.port}",
                                             nconn=2)
    finally:
        srv.close()
    assert step == 3 and doc == JCFG.to_meta()
    cfg = tl.LlamaConfig.from_meta(doc)
    flat = {k: np.asarray(v) for k, v in jwp._leaf_keys(jp)}
    from edl_tpu_torch.runtime.checkpoint import _leaf_keys

    got = dict(_leaf_keys(params))
    assert set(got) == set(flat)
    for k, v in flat.items():
        assert got[k].numpy().tobytes() == v.tobytes(), k
    toks = np.random.RandomState(0).randint(0, JCFG.vocab, (2, 12))
    want = np.asarray(jl.forward(jp, jnp.asarray(toks, jnp.int32), JCFG))
    out = tl.forward(params, torch.from_numpy(toks).long(), cfg).numpy()
    np.testing.assert_allclose(out, want, **TOL)


def test_the_reference_pulls_the_ports_push_bit_for_bit():
    cfg = tl.LlamaConfig.tiny()
    params = tl.init_params(cfg, seed=7, device="cpu")
    srv = twp.serve_params(params, cfg.to_meta(), step=2, token="t0k")
    addr = f"127.0.0.1:{srv.port}"
    try:
        with pytest.raises(ConnectionError):
            twp.fetch_params(addr)  # no token: the server answers nothing
        got, doc, step = jwp.fetch_params(addr, token="t0k")
        mine, mdoc, _ = twp.fetch_params(addr, token="t0k")
    finally:
        srv.close()
    assert step == 2 and doc == mdoc == cfg.to_meta()
    from edl_tpu_torch.runtime.checkpoint import _leaf_keys

    want = dict(_leaf_keys(params))
    for k, v in jwp._leaf_keys(got):
        assert np.asarray(v).tobytes() == want[k].numpy().tobytes(), k
    for k, v in _leaf_keys(mine):
        assert torch.equal(v, want[k]), k
    # bf16: the port's push carries the bytes and the dtype
    b16 = {k: v.to(torch.bfloat16) for k, v in params.items()
           if k != "layers"}
    srv = twp.serve_params(b16, cfg.to_meta())
    try:
        back, _, _ = twp.fetch_params(f"127.0.0.1:{srv.port}")
    finally:
        srv.close()
    for k, v in b16.items():
        assert back[k].dtype == torch.bfloat16 and torch.equal(back[k], v)


def test_a_dead_or_empty_peer_raises():
    import socket

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    addr = f"127.0.0.1:{s.getsockname()[1]}"
    s.close()  # nothing listens there
    with pytest.raises(ConnectionError, match="no shard server"):
        twp.fetch_params(addr, timeout_s=0.5)
    from edl_tpu_torch.runtime import checkpoint as tckpt
    from edl_tpu_torch.runtime.shard_server import ShardServer

    empty = tckpt.LocalSnapshot(step=0, pieces={}, primary={}, shapes={},
                                dtypes={})
    srv = ShardServer(lambda: empty)
    try:
        with pytest.raises(ConnectionError, match="no param pieces"):
            twp.fetch_params(f"127.0.0.1:{srv.port}")
    finally:
        srv.close()


def test_the_holder_runs_as_a_process(coord, tmp_path):
    """``python -m edl_tpu_torch.elasticity.holder``: a confirming
    holder frees its lease and exits 0; a dying one exits 9 holding it
    (the chips come back through ``LCRASH``); a zombie that remembers a
    stale epoch is fenced."""
    import os
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    addr = f"127.0.0.1:{coord.port}"

    def holder(*args):
        return subprocess.run(
            [sys.executable, "-m", "edl_tpu_torch.elasticity.holder",
             "--coordinator", addr, "--total", "8", *args],
            cwd=root, capture_output=True, text=True, timeout=120,
            env=dict(os.environ, PYTHONPATH=root))

    ok = holder("--holder", "serve:a", "--chips", "2", "--hold-s", "0.2",
                "--events-out", str(tmp_path / "a.jsonl"))
    assert ok.returncode == 0, ok.stderr[-2000:]
    lid, epoch, chips = ok.stdout.split()[1:4]
    assert (lid, chips) == ("L0001", "2")
    kinds = [json.loads(line).get("kind")  # the first line is a header
             for line in open(tmp_path / "a.jsonl")]
    assert kinds.count("lease.grant") == 1 and "lease.freed" in kinds
    dead = holder("--holder", "serve:b", "--chips", "3", "--mode", "die")
    assert dead.returncode == 9 and dead.stdout.startswith("LEASE L0002")
    b = DistributedChipBroker(coord.client(), 8, registry=TRegistry())
    assert b.free_chips == 5
    assert len(b.holder_crashed("serve:b")) == 1 and b.free_chips == 8
    zombie = holder("--holder", "serve:b", "--chips", "3", "--mode",
                    "zombie", "--lease-id", "L0002", "--epoch", "1")
    assert zombie.returncode == 0 and zombie.stdout.strip() == "FENCED True"
