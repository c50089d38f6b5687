"""Port parity: the control plane of ``edl_tpu_torch`` — the TrainingJob
API (``api/{resources,job,parser}.py``), the cluster model
(``cluster/{resource,topology,base,fake}.py``), the autoscaler and its
native planner (``scheduler/{autoscaler,native}.py``), the controller
(``controller/{updater,controller}.py``), the fleet monitor
(``monitor/collector.py``), the job store (``cli_store.py``) and the
seven control-plane verbs of ``python -m edl_tpu_torch`` — against the
reference's modules and ``edl_tpu.cli.main`` on the same inputs; then
chip_smoke.py's control phase, parts (a)-(d), on the CPU with a planted
fault tripping each gate.

Errors are compared by type and message; plans, traces, records and
printed lines whole.
"""

import dataclasses
import glob
import json
import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from edl_tpu.api import job as jjob
from edl_tpu.api import parser as jparser
from edl_tpu.api import resources as jres
from edl_tpu.cli import store as jstore
from edl_tpu.cli.main import main as jcli
from edl_tpu.cluster import fake as jfake
from edl_tpu.cluster import topology as jtopo
from edl_tpu.cluster.resource import ClusterResource as JClusterResource
from edl_tpu.cluster.resource import Hosts as JHosts
from edl_tpu.controller import controller as jctl
from edl_tpu.controller import updater as jupd
from edl_tpu.monitor import collector as jcol
from edl_tpu.scheduler import autoscaler as jas
from edl_tpu_torch import cli_store as tstore
from edl_tpu_torch.api import job as tjob
from edl_tpu_torch.api import parser as tparser
from edl_tpu_torch.api import resources as tres
from edl_tpu_torch.cli import main as tcli
from edl_tpu_torch.cluster import fake as tfake
from edl_tpu_torch.cluster import topology as ttopo
from edl_tpu_torch.cluster.resource import ClusterResource as TClusterResource
from edl_tpu_torch.cluster.resource import Hosts as THosts
from edl_tpu_torch.controller import controller as tctl
from edl_tpu_torch.controller import updater as tupd
from edl_tpu_torch.monitor import collector as tcol
from edl_tpu_torch.scheduler import autoscaler as tas
from edl_tpu_torch.scheduler import native as tnative

import chip_smoke

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MANIFESTS = sorted(glob.glob(os.path.join(ROOT, "examples", "*", "job.yaml")))
REF = types.SimpleNamespace(job=jjob, parser=jparser, res=jres, topo=jtopo,
                            fake=jfake, ctl=jctl, upd=jupd, col=jcol, as_=jas,
                            store=jstore, CR=JClusterResource, Hosts=JHosts)
PORT = types.SimpleNamespace(job=tjob, parser=tparser, res=tres, topo=ttopo,
                             fake=tfake, ctl=tctl, upd=tupd, col=tcol,
                             as_=tas, store=tstore, CR=TClusterResource,
                             Hosts=THosts)


def _outcome(fn, *a, **k):
    """A call's value, or its error as (type name, message)."""
    try:
        return ("ok", fn(*a, **k))
    except Exception as e:  # noqa: BLE001 — the error is the answer
        return ("raise", type(e).__name__, str(e))


def _plain(x):
    """Dataclasses, enums and tuples as plain JSON values."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return {f.name: _plain(getattr(x, f.name))
                for f in dataclasses.fields(x)}
    if isinstance(x, dict):
        return {str(k): _plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    if hasattr(x, "value") and type(x).__module__.endswith("job"):
        return x.value
    return x


# -- the API --------------------------------------------------------------------


@pytest.mark.parametrize("path", MANIFESTS,
                         ids=lambda p: os.path.basename(os.path.dirname(p)))
def test_example_manifests_round_trip_like_the_reference(path):
    """Each examples/*/job.yaml: the parsed job, its dict, the dict's
    round trip, the parser's warnings and both plans."""
    out = {}
    for name, m in (("ref", REF), ("port", PORT)):
        job = m.job.TrainingJob.from_yaml_file(path)
        d = job.to_dict()
        again = m.job.TrainingJob.from_dict(d)
        assert again.to_dict() == d
        p = m.parser.JobParser()
        warns = p.validate(job)
        out[name] = _plain({
            "dict": d, "job": job, "warnings": warns,
            "qualified": job.qualified_name, "elastic": job.elastic(),
            "chips": job.chips_per_worker(), "need_tpu": job.need_tpu(),
            "coordinator": p.parse_to_coordinator(job),
            "workers": p.parse_to_workers(job), "env": p.pod_env(job)})
    assert out["port"] == out["ref"]


BAD_MANIFESTS = {
    "no_name": {"spec": {"worker": {"min_replicas": 1}}},
    "max_below_min": {"metadata": {"name": "j"}, "spec": {
        "fault_tolerant": True,
        "worker": {"min_replicas": 4, "max_replicas": 2}}},
    "elastic_without_ft": {"metadata": {"name": "j"}, "spec": {
        "worker": {"min_replicas": 1, "max_replicas": 3}}},
    "chips_not_pow2": {"metadata": {"name": "j"}, "spec": {
        "worker": {"resources": {"limits": {"tpu": 3}}}}},
    "fractional_tpu": {"metadata": {"name": "j"}, "spec": {
        "worker": {"resources": {"limits": {"tpu": "1.5"}}}}},
    "bad_quantity": {"metadata": {"name": "j"}, "spec": {
        "worker": {"resources": {"requests": {"memory": "lots"}}}}},
    "unknown_mesh_axis": {"metadata": {"name": "j"}, "spec": {
        "mesh": {"zz": 2}}},
    "bad_growth_axis": {"metadata": {"name": "j"}, "spec": {
        "mesh": {"growth": "tp"}}},
    "pinned_growth_axis": {"metadata": {"name": "j"}, "spec": {
        "mesh": {"dp": 2}}},
    "fsdp_growth_no_ckpt": {"metadata": {"name": "j"}, "spec": {
        "fault_tolerant": True, "mesh": {"growth": "fsdp"},
        "worker": {"min_replicas": 1, "max_replicas": 2}}},
    "duplicate_volume": {"metadata": {"name": "j"}, "spec": {
        "volumes": [{"name": "a", "emptyDir": {}},
                    {"name": "a", "emptyDir": {}}]}},
    "mount_without_volume": {"metadata": {"name": "j"}, "spec": {
        "volume_mounts": [{"name": "x", "mount_path": "/x"}]}},
    "relative_mount": {"metadata": {"name": "j"}, "spec": {
        "volumes": [{"name": "a", "emptyDir": {}}],
        "volume_mounts": [{"name": "a", "mount_path": "x"}]}},
    "bad_env": {"metadata": {"name": "j"}, "spec": {"env": 7}},
    "warnings_only": {"metadata": {"name": "j"}, "spec": {
        "pserver": {"min_replicas": 1}, "env": {"EDL_JOB_NAME": "x"},
        "checkpoint_dir": "/elsewhere", "data_dir": "/d2",
        "volumes": [{"name": "a", "emptyDir": {}}],
        "volume_mounts": [{"name": "a", "mount_path": "/a"}]}},
}


@pytest.mark.parametrize("name", sorted(BAD_MANIFESTS))
def test_bad_manifests_fail_the_same_way(name):
    """from_dict and validate raise the reference's error (type and
    message) or give its warnings."""
    def run(m):
        got = _outcome(m.job.TrainingJob.from_dict, BAD_MANIFESTS[name])
        if got[0] == "raise":
            return got
        return _outcome(m.parser.JobParser().validate, got[1])

    ref, port = run(REF), run(PORT)
    assert port == ref
    if name == "warnings_only":
        assert ref[0] == "ok" and len(ref[1]) >= 3
    else:
        assert ref[0] == "raise"


def test_yaml_manifest_errors_and_legacy_keys_match(tmp_path):
    docs = ["- a list\n", "metadata: {name: j}\nspec: {worker: "
            "{min-instance: 2, max-instance: 3}, fault_tolerant: true}\n",
            "metadata: {name: j}\nspec:\n  trainer: {min_replicas: 1}\n"]
    for i, text in enumerate(docs):
        p = tmp_path / f"m{i}.yaml"
        p.write_text(text)
        ref = _outcome(jjob.TrainingJob.from_yaml_file, str(p))
        port = _outcome(tjob.TrainingJob.from_yaml_file, str(p))
        assert _plain(port) == _plain(ref)


QUANTITIES = ["1", "500m", "0.5", "2.5", "1Gi", "1G", "512Mi", "100M", "3Ki",
              "1e3", "1.5Gi", 7, 0.25, "  4 ", "abc", "-1", "1Zi", "", 2.0]


@pytest.mark.parametrize("fn", ["parse_quantity", "cpu_milli", "mem_mega",
                                "chip_count"])
def test_quantity_functions_match(fn):
    ref = [_outcome(getattr(jres, fn), q) for q in QUANTITIES]
    port = [_outcome(getattr(tres, fn), q) for q in QUANTITIES]
    assert port == ref


def test_resource_spec_and_requirements_match():
    out = {}
    for name, m in (("ref", REF), ("port", PORT)):
        rs = m.res.ResourceSpec.parse({"cpu": "1500m", "memory": "2Gi",
                                       "tpu": 4})
        rr = m.res.ResourceRequirements.parse(
            {"requests": {"cpu": "2"}, "limits": {"tpu_chips": 8}})
        dst = {"cpu": 1.0}
        m.res.add_resource_list(dst, {"cpu": 0.5, "memory": 2.0})
        dst["sum"] = _plain(rs + rs.scaled(3))
        dst["none"] = _plain([m.res.ResourceSpec.parse(None),
                              m.res.ResourceRequirements.parse(None)])
        out[name] = _plain([rs, rs.to_dict(), rr, rr.to_dict(), dst])
    assert out["port"] == out["ref"]


def test_topology_functions_match():
    def run(t):
        out = []
        for fam in sorted(t.FAMILIES) + ["cpu", "", "nope"]:
            out.append(_outcome(lambda: _plain(t.family(fam))))
            out.append(_outcome(t.slice_host_counts, fam))
            for n in (1, 2, 3, 4, 8, 16, 64):
                out.append(_outcome(t.topology_name, fam, n))
            for chips in (1, 4, 8):
                p = _outcome(t.policy_for_job, fam, chips)
                out.append(p if p[0] == "raise" else
                           [p[1](n) for n in range(0, 70)])
        for pol in (t.flexible, t.pow2, t.SliceShapePolicy("v5e", 16),
                    t.SliceShapePolicy("v4", 8, contiguous=False)):
            for lo, hi in ((0, 10), (2, 8), (3, 3), (1, 64)):
                out.append(t.legal_counts(pol, lo, hi))
                out += [t.floor_legal(n, pol, lo, hi) for n in range(0, 12)]
                out += [t.next_legal(n, d, pol, lo, hi)
                        for n in range(0, 12) for d in (1, -1)]
        return _plain(out)

    assert run(ttopo) == run(jtopo)


# -- the fake cluster ------------------------------------------------------------


def _fake_script(m):
    """Submits, updates, deletes, groups scaled and pods killed on the
    fake cluster, with a watcher and a scale listener recording."""
    hosts = [m.fake.FakeHost(f"h{i}", 8000, 16000, 4) for i in range(3)]
    hosts.append(m.fake.FakeHost("blk0", 8000, 16000, 4, ici_block="p0",
                                 ici_index=0))
    c = m.fake.FakeCluster(hosts=hosts)
    events, scales = [], []
    c.watch_jobs(lambda ev: events.append([ev.type.value, ev.job.name]))
    c.scale_listeners.append(lambda name, n: scales.append([name, n]))
    job = m.job.TrainingJob.from_dict({"metadata": {"name": "j"}, "spec": {
        "fault_tolerant": True, "worker": {
            "min_replicas": 2, "max_replicas": 6,
            "resources": {"requests": {"cpu": "1", "memory": "1Gi"},
                          "limits": {"tpu": 4}}}}})
    p = m.parser.JobParser()
    p.validate(job)
    c.submit_job(job)
    c.submit_job(job)
    out = [_plain(c.create_coordinator(p.parse_to_coordinator(job))),
           _plain(c.create_worker_group(p.parse_to_workers(job)))]
    out.append(_outcome(c.create_worker_group, p.parse_to_workers(job))[:2])
    g = c.get_worker_group(job)
    g.parallelism = 5
    c.update_worker_group(g)
    out.append(_outcome(c.update_worker_group, g)[:2])  # stale version
    out += [c.job_pods(job), _plain(c.inquiry_resource())]
    c.add_external_pod("nginx", 4000, 1000)
    c.add_external_pod("pinned", 1000, 1000, host="h1")
    out.append(_outcome(c.add_external_pod, "x", 1, 1, host="nope")[:2])
    name = sorted(p_.name for p_ in c.pods.values() if p_.role == "worker")[0]
    c.kill_pod(name)
    c.reconcile()
    c.remove_host("h2")
    c.reconcile()
    out += [c.job_pods(job), _plain(c.get_worker_group(job)),
            sorted([p_.name, p_.phase, p_.host] for p_ in c.pods.values()),
            _plain(c.get_coordinator("default", "j-coordinator"))]
    c.finish_workers("default", "j-worker", success=True)
    c.reconcile()
    out += [c.job_pods(job), _plain(c.get_worker_group(job))]
    c.delete_worker_group("default", "j-worker")
    c.delete_coordinator("default", "j-coordinator")
    c.delete_job("default", "j")
    c.delete_job("default", "j")
    out += [_outcome(c.get_worker_group, job)[:2], events, scales,
            [j.name for j in c.list_jobs()], _plain(c.inquiry_resource())]
    return out


def test_fake_cluster_event_sequences_match():
    assert _fake_script(PORT) == _fake_script(REF)


# -- the planners ---------------------------------------------------------------


class _Group:
    def __init__(self, parallelism):
        self.parallelism = parallelism


def _plan_inputs(m, seed, policy_name):
    """tests/test_native_sched.py's random fleets, for package ``m``."""
    rng = np.random.RandomState(seed)
    jobs = []
    for i in range(int(rng.randint(1, 8))):
        lo = int(rng.randint(0, 4))
        hi = lo + int(rng.randint(0, 8))
        cur = int(rng.randint(0, hi + 2))
        chips = int(rng.choice([0, 1, 2, 4]))
        cpu = int(rng.choice([500, 1000, 4000]))
        mem = int(rng.choice([100, 1000, 4000]))
        accel = (str(rng.choice(["v5e", "v4", "cpu", ""]))
                 if policy_name == "auto" else "")
        job = m.job.TrainingJob.from_dict({"metadata": {"name": f"job{i}"},
                                          "spec": {
            "fault_tolerant": True,
            **({"accelerator_type": accel} if accel else {}),
            "worker": {"min_replicas": lo, "max_replicas": hi, "resources": {
                "requests": {"cpu": f"{cpu}m", "memory": f"{mem}M"},
                "limits": {"tpu": chips}}}}})
        js = m.as_.JobState(config=job)
        js.group = _Group(cur)
        jobs.append(js)
    hosts = m.Hosts(cpu_idle_milli={}, mem_free_mega={}, chips_free={})
    r = m.CR()
    for i in range(int(rng.randint(1, 10))):
        name = f"h{i:02d}"
        cpu = int(rng.choice([8000, 16000, 32000]))
        mem = int(rng.choice([16000, 32000]))
        chips = int(rng.choice([0, 4, 8]))
        hosts.cpu_idle_milli[name] = cpu
        hosts.mem_free_mega[name] = mem
        hosts.chips_free[name] = chips
        if policy_name == "auto" and chips > 0 and rng.rand() < 0.8:
            hosts.ici_block[name] = f"pod{i // 4}"
            hosts.ici_index[name] = i % 4
        r.cpu_total_milli += cpu
        r.mem_total_mega += mem
        r.chip_total += chips
    r.hosts = hosts
    for j in jobs:
        cur = j.group.parallelism
        r.chip_limit += j.chips_per_worker() * cur
        r.cpu_request_milli += j.cpu_request_milli() * cur
        r.mem_request_mega += j.mem_request_mega() * cur
    policy = ("auto" if policy_name == "auto"
              else m.topo.POLICIES[policy_name])
    return jobs, r, float(rng.choice([0.8, 0.9, 0.97, 1.0])), policy


@pytest.mark.parametrize("policy_name", ["flexible", "pow2", "auto"])
@pytest.mark.parametrize("seed", range(8))
def test_planners_agree_on_seeded_fleets(seed, policy_name):
    """The port's Python planner, the port's native planner and the
    reference's Python planner give one plan."""
    jobs, r, load, pol = _plan_inputs(REF, seed, policy_name)
    ref = jas.scale_all_jobs_dry_run(jobs, r.copy(), load, pol)
    jobs, r, load, pol = _plan_inputs(PORT, seed, policy_name)
    py = tas.scale_all_jobs_dry_run(jobs, r.copy(), load, pol)
    nat = tnative.plan_native(jobs, r, load,
                              [tas.resolve_policy(pol, j) for j in jobs])
    assert nat is not None and py == ref
    # the Python plan names the jobs it touched, the native one every job
    assert {k: v for k, v in nat.items() if v} == {
        k: v for k, v in ref.items() if v}
    assert set(ref) <= set(nat)


def test_plan_native_declines_custom_policies_and_missing_library(
        monkeypatch):
    jobs, r, load, _ = _plan_inputs(PORT, 3, "flexible")
    assert tnative.plan_native(jobs, r, load, [lambda n: True] * len(jobs)) \
        is None
    monkeypatch.setattr(tnative, "_lib", None)
    monkeypatch.setattr(tnative, "ensure_native_built", lambda: False)
    assert not tnative.available()
    assert tnative.plan_native(jobs, r, load,
                               [ttopo.flexible] * len(jobs)) is None


def test_autoscaler_ticks_match_native_and_python(monkeypatch):
    """A fleet under submissions and a host loss: the port's autoscaler
    retargets as the reference's does, native against native, Python
    against Python, and in Python when the native planner declines."""
    def run(m, native):
        c = m.fake.FakeCluster(hosts=[m.fake.FakeHost(f"h{i}", 16000, 64000,
                                                      4) for i in range(6)])
        a = m.as_.Autoscaler(c, max_load_desired=0.9, use_native=native)
        ctl = m.ctl.Controller(c, autoscaler=a)
        out = []
        for i, (lo, hi, chips) in enumerate([(1, 6, 4), (2, 4, 2),
                                             (1, 3, 1)]):
            c.submit_job(chip_smoke._elastic_job(
                types.SimpleNamespace(job=m.job), f"j{i}", lo, hi, chips))
            for _ in range(3):
                c.reconcile()
                out.append(a.tick())
                ctl.step()
        c.remove_host("h0")
        for _ in range(3):
            c.reconcile()
            out.append(a.tick())
            ctl.step()
        out.append({k: str(u.phase.value) for k, u in ctl.updaters.items()})
        return out

    # the native plan lists the jobs in their order, the Python plan in
    # its passes' order, and the plan is applied in that order: the
    # fleets part at the seventh tick (the reference's too)
    ref_py, ref_native = run(REF, False), run(REF, True)
    assert ref_py[6] != ref_native[6]
    assert run(PORT, True) == ref_native
    assert run(PORT, False) == ref_py
    monkeypatch.setattr(tnative, "plan_native", lambda *a: None)
    assert run(PORT, True) == ref_py


# -- the controller --------------------------------------------------------------


def _fleet(m, n=4):
    return m.fake.FakeCluster(hosts=[m.fake.FakeHost(f"h{i}", 8000, 16000, 4)
                                     for i in range(n)])


def _job(m, name="j1", lo=2, hi=8, ft=True, chips=4):
    return m.job.TrainingJob.from_dict({"metadata": {"name": name}, "spec": {
        "fault_tolerant": ft, "worker": {
            "min_replicas": lo, "max_replicas": hi, "resources": {
                "requests": {"cpu": "500m", "memory": "1Gi", "tpu": chips},
                "limits": {"tpu": chips}}}}})


def _state(u, job, c):
    st = job.status
    return [u.phase.value, st.reason, st.parallelism, st.master.state.value,
            st.worker.state.value, list(c.job_pods(job)), st.reshard_count]


def _partial_failure(m):
    c, job = _fleet(m), _job(m)
    u = m.upd.JobUpdater(job, c)
    out = []
    for _ in range(2):
        u.step()
        out.append(_state(u, job, c))
    pods = sorted((p for p in c.pods.values() if p.role == "worker"),
                  key=lambda p: p.name)
    for p in pods[:2]:
        c.kill_pod(p.name)
        u.step()
        out.append(_state(u, job, c))
    return out


def _replacement_churn(m):
    c, job = _fleet(m), _job(m)
    u = m.upd.JobUpdater(job, c)
    u.step()
    u.step()
    out = []
    for _ in range(3):
        pods = sorted((p for p in c.pods.values()
                       if p.role == "worker" and p.phase == "running"),
                      key=lambda p: p.name)
        c.kill_pod(pods[0].name)
        c.reconcile()
        u.step()
        out.append(_state(u, job, c))
    return out


def _non_ft(m):
    c, job = _fleet(m), _job(m, ft=False, lo=2, hi=2)
    u = m.upd.JobUpdater(job, c)
    u.step()
    u.step()
    pod = sorted(p.name for p in c.pods.values() if p.role == "worker")[0]
    c.kill_pod(pod)
    u.step()
    return [_state(u, job, c)]


def _invalid(m):
    c, job = _fleet(m), _job(m, ft=False, lo=2, hi=8)
    u = m.upd.JobUpdater(job, c)
    u.step()
    u.step()
    return [_state(u, job, c)]


def _success(m):
    c, job = _fleet(m), _job(m)
    u = m.upd.JobUpdater(job, c)
    u.step()
    u.step()
    c.finish_workers("default", "j1-worker", success=True)
    u.step()
    u.step()
    return [_state(u, job, c), sorted(c.coordinators)]


def _no_room(m):
    c, job = _fleet(m, n=1), _job(m, lo=2, hi=2, chips=4)
    u = m.upd.JobUpdater(job, c)
    out = []
    for _ in range(3):
        u.step()
        out.append(_state(u, job, c))
    return out


def _controller_sync(m):
    c = _fleet(m)
    ctl = m.ctl.Controller(c, max_load_desired=1.0)
    job = _job(m)
    job.namespace = "team-a"
    c.submit_job(job)
    ctl.step()
    out = [ctl.phase_of("team-a/j1").value, ctl.autoscaler.tick(),
           ctl.phase_of("team-a/j1").value]
    ctl.updaters["team-a/j1"].on_reshard_done(stall_s=1.5)
    out.append(_state(ctl.updaters["team-a/j1"], job, c))
    c.delete_job("team-a", "j1")
    out += [sorted(ctl.updaters), sorted(c.groups)]
    return out


@pytest.mark.parametrize("case", [
    _partial_failure, _replacement_churn, _non_ft, _invalid, _success,
    _no_room, _controller_sync], ids=lambda f: f.__name__[1:])
def test_updater_state_machine_matches_in_failure_cases(case):
    """tests/test_controller.py's cases: every phase, reason, status and
    pod census after each step, on both packages."""
    assert case(PORT) == case(REF)


def test_controller_updaters_map_is_threadsafe_under_churn():
    """The reference's `_lock` around the updaters map: watch events on
    one thread while the ticker steps on another lose no updater and
    resurrect none."""
    import threading

    c = _fleet(PORT, n=16)
    ctl = tctl.Controller(c, max_load_desired=1.0)
    errors, stop = [], threading.Event()

    def ticker():
        while not stop.is_set():
            try:
                ctl.step()
            except RuntimeError as e:
                errors.append(e)

    t = threading.Thread(target=ticker, daemon=True)
    t.start()
    jobs = [_job(PORT, name=f"churn{i}", lo=1, hi=2) for i in range(24)]
    try:
        for i, job in enumerate(jobs):
            ctl.on_add(job)
            if i % 2:
                ctl.on_delete(job)
    finally:
        stop.set()
        t.join(5)
    assert not errors
    assert {u.rsplit("/", 1)[-1] for u in ctl.updaters} == {
        f"churn{i}" for i in range(0, 24, 2)}
    before = dict(ctl.updaters)
    ctl.on_add(jobs[0])
    assert ctl.updaters == before
    assert isinstance(ctl._lock, type(threading.Lock()))


def test_controller_threaded_run_reaches_the_target():
    import time

    c = _fleet(PORT)
    ctl = tctl.Controller(c, max_load_desired=1.0)
    ctl.autoscaler.loop_seconds = 0.05
    ctl.run(updater_interval_s=0.05)
    job = _job(PORT)
    c.submit_job(job)
    deadline = time.time() + 5
    try:
        while time.time() < deadline:
            if c.get_worker_group(job).parallelism == 4:
                break
            time.sleep(0.05)
    finally:
        ctl.stop()
    assert c.get_worker_group(job).parallelism == 4


# -- the elastic squeeze (chip_smoke part (a)) -------------------------------------


def test_squeeze_trace_is_the_references():
    """examples/elastic_demo.py's squeeze: the reference's run (Python
    planner) gives chip_smoke's literal trace, and so do the port's
    with the native planner and with the Python one."""
    ref, ref_created, _ = chip_smoke.control_squeeze("edl_tpu",
                                                     use_native=False)
    assert [list(x) for x in ref] == [list(x) for x in
                                      chip_smoke.CONTROL_SQUEEZE_TRACE]
    for native in (True, False):
        trace, created, last = chip_smoke.control_squeeze(use_native=native)
        chip_smoke._squeeze_check(trace, created)
        assert trace == ref and created == ref_created
    assert last.chip_util == 100.0


def test_squeeze_gate_trips_on_planted_faults():
    trace, created, _ = chip_smoke.control_squeeze()
    bad = [list(x) for x in trace]
    bad[-1] = [{**bad[-1][0], "example": [7, 7]}, []]
    with pytest.raises(AssertionError, match="squeeze trace"):
        chip_smoke._squeeze_check(bad, created)
    with pytest.raises(AssertionError, match="recreated"):
        chip_smoke._squeeze_check(trace, {**created, "example-worker": 2})


# -- the fleet (chip_smoke part (b)) ---------------------------------------------

SMALL_FLEET = dict(chip_smoke.CONTROL_FLEET, hosts=24, jobs=10, ticks=2)


def test_fleet_part_runs_and_its_gate_trips(monkeypatch):
    row = chip_smoke.control_fleet(c=SMALL_FLEET)
    assert row["candidates"] > 0 and len(row["ticks_host_ms"]) == 2
    assert 0 < row["chips_requested"] <= row["chips_total"] == 24 * 8
    ref = chip_smoke.control_fleet("edl_tpu", c=SMALL_FLEET)
    for k in ("retargeted_per_tick", "candidates", "plan_changes",
              "chips_requested", "chips_total"):
        assert row[k] == ref[k], k
    r = TClusterResource(chip_total=8, chip_request=4)
    with pytest.raises(AssertionError, match="plan_native returned None"):
        chip_smoke._fleet_check({"a": 1}, None, r, [1])
    with pytest.raises(AssertionError, match="native plan != Python"):
        chip_smoke._fleet_check({"a": 1}, {"a": 2}, r, [1])
    chip_smoke._fleet_check({"a": 1}, {"a": 1}, r, [1])
    monkeypatch.setattr(tnative, "plan_native", lambda *a: None)
    with pytest.raises(AssertionError, match="plan_native returned None"):
        chip_smoke.control_fleet(c=SMALL_FLEET)


# -- the job store and the verbs (chip_smoke part (c)) ------------------------------


def test_job_store_reads_across_packages_both_ways(tmp_path):
    """Each package reads a store the other wrote, and both write the
    same bytes."""
    path = os.path.join(ROOT, "examples", "ctr", "job.yaml")
    trees = {}
    for name, (w, r) in {"ref_then_port": (REF, PORT),
                         "port_then_ref": (PORT, REF)}.items():
        root = tmp_path / name
        ws = w.store.JobStore(str(root))
        ws.submit(w.job.TrainingJob.from_yaml_file(path))
        ws.write_status("default", "ctr", {"phase": "running", "x": 1})
        ws.write_cluster({"chip_total": 8})
        rs = r.store.JobStore(str(root))
        assert rs.list_keys() == [("default", "ctr")]
        assert rs.load("default", "ctr").to_dict() == \
            w.job.TrainingJob.from_yaml_file(path).to_dict()
        assert rs.list_statuses() == {("default", "ctr"):
                                      {"phase": "running", "x": 1}}
        assert rs.read_cluster() == {"chip_total": 8}
        assert rs.delete("default", "ctr") and not rs.delete("default", "ctr")
        ws.submit(w.job.TrainingJob.from_yaml_file(path))
        trees[name] = {os.path.relpath(p, root): open(p, "rb").read()
                       for p in glob.glob(str(root / "**" / "*"),
                                          recursive=True)
                       if os.path.isfile(p)}
    assert trees["ref_then_port"] == trees["port_then_ref"]


def test_manifest_literals_are_the_example_yamls():
    import yaml

    for name, sub in (("ctr", "ctr"), ("llama-fsdp", "llama")):
        with open(os.path.join(ROOT, "examples", sub, "job.yaml")) as f:
            assert yaml.safe_load(f) == chip_smoke.CONTROL_MANIFESTS[name]


@pytest.mark.parametrize("have_yaml", [True, False])
def test_job_verbs_match_the_reference(tmp_path, have_yaml):
    """validate, submit, controller, list, status, monitor --json and
    delete through each package's main give chip_smoke's literal record
    (without yaml the store is written directly, as on a machine
    without PyYAML)."""
    rec = {}
    for name, (main, m) in {"ref": (jcli, REF), "port": (tcli, PORT)}.items():
        rec[name] = chip_smoke.control_verbs(
            main, str(tmp_path / name), have_yaml, m.store.JobStore,
            m.job.TrainingJob)
    assert rec["port"] == rec["ref"]
    chip_smoke._verbs_check(rec["port"])
    assert ("validate" in rec["port"]) == have_yaml


def test_verbs_gate_trips_on_a_planted_difference(tmp_path):
    rec = chip_smoke.control_verbs(tcli, str(tmp_path))
    rec["status"]["ctr"][2] = 7
    with pytest.raises(AssertionError, match="job verbs differ"):
        chip_smoke._verbs_check(rec)


def _both(tmp_path, argv_of, capsys):
    """(exit code, stdout, stderr) of one verb through each main, on
    stores seeded alike."""
    out = {}
    for name, main in (("ref", jcli), ("port", tcli)):
        d = tmp_path / name
        d.mkdir(exist_ok=True)
        capsys.readouterr()
        try:
            rc = main(argv_of(str(d)))
        except SystemExit as e:
            rc = ("exit", e.code)
        o = capsys.readouterr()
        out[name] = (rc, o.out.replace(str(d), "D"), o.err)
    return out


def test_verbs_refusals_match(tmp_path, capsys):
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps(BAD_MANIFESTS["elastic_without_ft"]))
    for argv_of in (
            lambda d: ["validate", str(bad)],
            lambda d: ["status", "nope", "--store", d],
            lambda d: ["delete", "nope", "--store", d, "--namespace", "x"],
            lambda d: ["list", "--store", d],
            lambda d: ["controller"],
            lambda d: ["monitor", "--store", d, "--polls", "1", "--tsdb", d,
                       "--rules", str(bad)]):
        got = _both(tmp_path, argv_of, capsys)
        assert got["port"][:2] == got["ref"][:2]
        assert got["port"][2].splitlines()[-1:] == \
            got["ref"][2].splitlines()[-1:]
    with pytest.raises(Exception) as ref_e:
        jcli(["submit", str(bad), "--store", str(tmp_path / "s")])
    with pytest.raises(Exception) as port_e:
        tcli(["submit", str(bad), "--store", str(tmp_path / "s")])
    assert (type(port_e.value).__name__, str(port_e.value)) == \
        (type(ref_e.value).__name__, str(ref_e.value))


def test_monitor_text_and_alerts_match(tmp_path, capsys):
    """``monitor`` without --json (the table, its timestamp line left
    out) and with ``--tsdb``: the same lines and alert block."""
    for name, main in (("ref", jcli), ("port", tcli)):
        d = str(tmp_path / name)
        for n in chip_smoke.CONTROL_MANIFESTS:
            p = tmp_path / f"{n}.json"
            p.write_text(json.dumps(chip_smoke.CONTROL_MANIFESTS[n]))
            assert main(["submit", str(p), "--store", d]) == 0
        assert main(["controller", "--store", d, "--iterations", "3",
                     "--tick-s", "0", "--no-native-scheduler",
                     "--slice-policy", "pow2", "--hosts", "2"]) == 0
    capsys.readouterr()
    got = {}
    for name, main in (("ref", jcli), ("port", tcli)):
        d = str(tmp_path / name)
        tsdb = tmp_path / f"tsdb-{name}"
        tsdb.mkdir()
        assert main(["monitor", "--store", d, "--polls", "1"]) == 0
        text = capsys.readouterr().out.splitlines()[1:]
        assert main(["monitor", "--store", d, "--polls", "1", "--json",
                     "--tsdb", str(tsdb)]) == 0
        rec = json.loads(capsys.readouterr().out)
        rec.pop("ts")
        rec.pop("last_stall_s")  # wall seconds of each run's reshards
        got[name] = (text, rec)
    assert got["port"] == got["ref"]
    assert any("PENDING-JOBS" in x for x in got["port"][0])


def test_controller_kube_flags_exit_1_naming_the_roadmap_item(monkeypatch):
    """The in-cluster mode is ported (ROADMAP item 9d-kube): ``--kube``
    outside a cluster fails as the reference's does, and ``--kube-url``
    runs the kube loop against tests/fake_kube.py and exits 0, on both
    packages (tests/test_torch_kube.py holds the loop to the
    reference's)."""
    from edl_tpu.cluster import kube as jkube
    from edl_tpu_torch.cluster import kube as tkube
    from tests.fake_kube import FakeKubeServer

    for var in ("EDL_KUBE_URL", "KUBERNETES_SERVICE_HOST"):
        monkeypatch.delenv(var, raising=False)
    assert _outcome(tcli, ["controller", "--kube"]) == \
        _outcome(jcli, ["controller", "--kube"])
    assert _outcome(tcli, ["controller", "--kube"])[1] == "RuntimeError"
    sources = []  # the verbs leave their watch threads running
    for mod in (jkube, tkube):
        def init(self, *a, _init=mod.KubeJobSource.__init__, **k):
            _init(self, *a, **k)
            sources.append(self)
        monkeypatch.setattr(mod.KubeJobSource, "__init__", init)
    server = FakeKubeServer()
    try:
        argv = ["controller", "--kube-url", server.url, "--iterations", "1",
                "--tick-s", "0"]
        assert tcli(argv) == 0 and jcli(argv) == 0
    finally:
        for src in sources:
            src.close()
        server.close()
    assert len(sources) == 2


def test_controller_metrics_port_serves_the_census():
    """``controller --metrics-port``: each /metrics GET samples the live
    cluster through the port's exporter and ``registry_from_sample``;
    the scraped census equals the reference's on the same cluster."""
    import importlib

    from edl_tpu import obs as jobs_
    from edl_tpu_torch import cli as tcli_mod
    from edl_tpu_torch import obs as tobs

    jmain_mod = importlib.import_module("edl_tpu.cli.main")

    args = types.SimpleNamespace(hosts=2, chips_per_host=8,
                                 host_cpu_milli=96_000,
                                 host_mem_mega=393_216, metrics_port=0)
    got = {}
    for name, mod, m, obs in (("ref", jmain_mod, REF, jobs_),
                              ("port", tcli_mod, PORT, tobs)):
        cluster = mod._build_cluster(args)
        cluster.submit_job(_job(m, name="fx", lo=1, hi=4, chips=4))
        cluster.reconcile()
        exp = mod._start_fleet_exporter(args, cluster)
        try:
            got[name] = obs.parse_prometheus_text(obs.scrape(exp.url))
        finally:
            exp.stop()
        assert mod._start_fleet_exporter(
            types.SimpleNamespace(metrics_port=None), cluster) is None
    assert got["port"] == got["ref"]
    assert got["port"]["edl_fleet_chip_total"] == [({}, 16.0)]


def test_control_verbs_import_neither_torch_nor_jax(tmp_path):
    """The seven verbs and the package's top level in one process:
    neither torch nor jax is ever imported."""
    for n, doc in chip_smoke.CONTROL_MANIFESTS.items():
        (tmp_path / f"{n}.json").write_text(json.dumps(doc))
    store = str(tmp_path / "store")
    code = f"""
import sys
import edl_tpu_torch
from edl_tpu_torch.cli import main
d, s = {str(tmp_path)!r}, {store!r}
rcs = [main(["validate", d + "/ctr.json"]),
       main(["submit", d + "/ctr.json", "--store", s]),
       main(["submit", d + "/llama-fsdp.json", "--store", s]),
       main(["controller", "--store", s, "--iterations", "2",
             "--tick-s", "0"]),
       main(["list", "--store", s]), main(["status", "ctr", "--store", s]),
       main(["monitor", "--store", s, "--polls", "1", "--json"]),
       main(["delete", "ctr", "--store", s])]
bad = [m for m in ("torch", "jax") if m in sys.modules]
print("RESULT", rcs, bad, edl_tpu_torch.TrainingJob.__module__)
"""
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path),
                         env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    line = [x for x in out.stdout.splitlines() if x.startswith("RESULT")][0]
    assert line == ("RESULT [0, 0, 0, 0, 0, 0, 0, 0] [] "
                    "edl_tpu_torch.api.job")


def test_package_reexports_the_reference_names():
    import edl_tpu
    import edl_tpu_torch

    names = [n for n in dir(edl_tpu) if not n.startswith("_")
             and isinstance(getattr(edl_tpu, n), type)]
    assert len(names) == 10
    for n in names:
        assert getattr(edl_tpu_torch, n).__name__ == n
        assert getattr(edl_tpu_torch, n).__module__.startswith(
            "edl_tpu_torch.api.")


# -- the monitor ------------------------------------------------------------------


class _FakeServingMetrics:
    def __init__(self, registry):
        self.registry = registry

    def snapshot(self):
        return {"requests_total": 8.0, "tokens_out_total": 256.0,
                "ttft_p50_s": 0.12, "queue_depth": 0.0}


def test_serving_source_samples_and_renders_like_the_reference():
    from edl_tpu.obs import metrics as jm
    from edl_tpu_torch.obs import metrics as tm

    got = {}
    for name, col, m in (("ref", jcol, jm), ("port", tcol, tm)):
        r = m.MetricsRegistry()
        r.gauge("edl_mfu", "mfu", ("phase",)).set(0.25, phase="prefill")
        r.gauge("edl_hbm_bytes", "b", ("category",)).set(1024, category="kv")
        s = col.Collector(col.ServingSource(_FakeServingMetrics(r)),
                          interval_s=0).poll()
        rec = s.to_record()
        rec.pop("ts")
        got[name] = (rec, s.render())
    assert got["port"] == got["ref"]
    assert got["port"][0]["efficiency"] == {"mfu_prefill": 0.25,
                                            "hbm_bytes_kv": 1024}


def test_chip_smoke_serving_part_gates_on_the_snapshot():
    from edl_tpu_torch.obs import metrics as tm

    r = tm.MetricsRegistry()
    r.gauge("edl_mfu", "mfu", ("phase",)).set(0.3, phase="decode")
    m = _FakeServingMetrics(r)
    row = chip_smoke.control_serving(m)
    assert row["efficiency"] == {"mfu_decode": 0.3}
    with pytest.raises(AssertionError, match="no efficiency block"):
        chip_smoke.control_serving(_FakeServingMetrics(tm.MetricsRegistry()))

    class Drifting(_FakeServingMetrics):
        n = 0

        def snapshot(self):
            self.n += 1
            return {"requests_total": float(self.n)}

    with pytest.raises(AssertionError, match="!= snapshot"):
        chip_smoke.control_serving(Drifting(r))


# -- the queue-fed flagship step (chip_smoke part (d)), at a tiny Llama ----------


def _counting_flash(monkeypatch):
    """Count the CPU plain versions as the card's kernels."""
    from edl_tpu_torch.ops import flash_attention as fa

    lse, bwd = fa.flash_attention_lse_ref, fa.flash_attention_bwd_ref

    def counted_lse(*a, **k):
        fa._launched("flash_fwd_lse")
        return lse(*a, **k)

    def counted_bwd(*a, **k):
        fa._launched("flash_bwd_dq")
        fa._launched("flash_bwd_dkv")
        return bwd(*a, **k)

    monkeypatch.setattr(fa, "flash_attention_lse_ref", counted_lse)
    monkeypatch.setattr(fa, "flash_attention_bwd_ref", counted_bwd)


TINY_QUEUE = dict(chip_smoke.CONTROL_QUEUE, seq=32)


def _tiny_cfg():
    from edl_tpu_torch.models import llama

    return dataclasses.replace(llama.LlamaConfig.tiny(), use_flash=True,
                               remat=True, dtype=torch.float32)


def test_queue_part_trains_every_sample_once_on_the_cpu(monkeypatch):
    """64 samples in chunks of 6, batches of 4, w1 released mid-pass: 16
    steps, every sample once, losses equal to the directly fed steps,
    2L / L / L launches a step and the coordinators' script."""
    torch.manual_seed(0)
    _counting_flash(monkeypatch)
    cfg = _tiny_cfg()
    counts, row = chip_smoke.control_queue("cpu", cfg, device="cpu",
                                           c=TINY_QUEUE)
    L = cfg.n_layers
    assert row["steps"] == 16
    assert counts == {"flash_fwd": 0, "flash_fwd_lse": 32 * L,
                      "flash_bwd_dq": 16 * L, "flash_bwd_dkv": 16 * L}
    assert row["losses_equal_direct"] and row["losses"][-1] < row["losses"][0]
    assert row["queue_stats"]["done"] == 11 and row["queue_stats"]["dead"] == 0
    flat = [i for rs in row["ranges"] for s, e in rs for i in range(s, e)]
    assert sorted(flat) == list(range(64))
    assert row["coordinator_script_answers"] > 30


def test_queue_gates_trip_on_planted_faults():
    ok = dict(seen=list(range(8)), n_samples=8, losses=[1.0, 0.5],
              direct=[1.0, 0.5], counts={"flash_fwd": 0, "flash_fwd_lse": 8,
                                         "flash_bwd_dq": 4,
                                         "flash_bwd_dkv": 4},
              steps=2, n_layers=2, released=1)
    chip_smoke._queue_check(**ok)
    for bad, match in (
            (dict(seen=[0, 1, 1, 3, 4, 5, 6, 7]), "repeated"),
            (dict(seen=list(range(7))), "missing"),
            (dict(direct=[1.0, 0.5000001]), "directly fed"),
            (dict(released=0), "released 0"),
            (dict(counts={**ok["counts"], "flash_bwd_dq": 3}),
             "flash launches"),
            (dict(counts={**ok["counts"], "flash_fwd": 1}),
             "flash launches")):
        with pytest.raises(AssertionError, match=match):
            chip_smoke._queue_check(**{**ok, **bad})


def test_queue_part_trips_when_the_batcher_repeats_a_sample(monkeypatch):
    from edl_tpu_torch.runtime import data as tdata_mod

    _counting_flash(monkeypatch)
    real = tdata_mod.QueueBatcher.next_batch

    def repeating(self, n, rollover=False):
        b = real(self, n, rollover)
        if b is not None and b["idx"][0] == 0:
            b = {k: np.concatenate([v[:1], v[:-1]]) for k, v in b.items()}
        return b

    monkeypatch.setattr(tdata_mod.QueueBatcher, "next_batch", repeating)
    with pytest.raises(AssertionError, match="repeated"):
        chip_smoke.control_queue("cpu", _tiny_cfg(), device="cpu",
                                 c=TINY_QUEUE)


def test_coordinator_gate_trips_when_make_coordinator_falls_back(
        monkeypatch):
    from edl_tpu_torch.runtime import coordinator as tco

    assert chip_smoke._coordinator_check() > 30
    monkeypatch.setattr(tco, "ensure_native_built", lambda: False)
    with pytest.raises(AssertionError, match="not the native coordinator"):
        chip_smoke._coordinator_check()


def test_control_phase_runs_on_the_cpu(monkeypatch, capsys):
    """The whole phase, cut: a tiny Llama at T32, a 24-host fleet of 10
    jobs, the CPU's plain attention counted as the kernels."""
    from edl_tpu_torch.obs import metrics as tm

    _counting_flash(monkeypatch)
    r = tm.MetricsRegistry()
    r.gauge("edl_mfu", "mfu", ("phase",)).set(0.3, phase="prefill")
    cfg = _tiny_cfg()
    counts = chip_smoke.control_phase("cpu", _FakeServingMetrics(r),
                                      device="cpu", cfg=cfg,
                                      fleet_c=SMALL_FLEET,
                                      queue_c=TINY_QUEUE)
    assert counts["flash_bwd_dq"] == 16 * cfg.n_layers
    row = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert row["phase"] == "control" and row["verbs"]["have_yaml"]
    assert row["queue"]["steps"] == 16 and row["phase_s"] < 90
