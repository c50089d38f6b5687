"""Port parity: the Kubernetes backend of ``edl_tpu_torch``
(``cluster/kube.py``: ``KubeApi``, ``KubeCluster``, ``KubeJobSource``) and
``controller --kube`` in the port's CLI.

The reference's cases (``tests/test_kube.py``) run against the port: the
file's source with its imports of ``edl_tpu`` pointed at ``edl_tpu_torch``,
each case a parametrised case here, on ``tests/fake_kube.py``. Then the
two packages on two ``FakeKubeServer``s driven by one script: the same
Job, Deployment and Service manifests and the same status bodies (the
pods' commands name each package's own modules), and the same per-tick
targets of a seeded fleet, each planner against the reference's same
planner.
"""

import inspect
import json
import types

import numpy as np
import pytest

from edl_tpu.api import job as jjob
from edl_tpu.api.parser import JobParser as JJobParser
from edl_tpu.cluster import kube as jkube
from edl_tpu.controller.controller import Controller as JController
from edl_tpu.scheduler.autoscaler import Autoscaler as JAutoscaler
from edl_tpu_torch.api import job as tjob
from edl_tpu_torch.api.parser import JobParser as TJobParser
from edl_tpu_torch.cluster import kube as tkube
from edl_tpu_torch.controller.controller import Controller as TController
from edl_tpu_torch.scheduler.autoscaler import Autoscaler as TAutoscaler
from tests.fake_kube import FakeKubeServer
from tests.port_cases import case_names, port_cases

import chip_smoke


KUBE = port_cases("test_kube")
KUBE_CASES = case_names(KUBE)


def test_the_reference_file_is_pointed_at_the_port():
    assert KUBE.KubeCluster is tkube.KubeCluster
    assert KUBE.KubeJobSource is tkube.KubeJobSource
    assert len(KUBE_CASES) == 24


@pytest.mark.parametrize("case", KUBE_CASES)
def test_reference_kube_case_on_the_port(case):
    """Each case of tests/test_kube.py with the port's modules; the
    ``server`` and ``cluster`` fixtures as that file builds them."""
    fn = getattr(KUBE, case)
    params = inspect.signature(fn).parameters
    server = FakeKubeServer()
    try:
        kw = {}
        if "server" in params:
            kw["server"] = server
        if "cluster" in params:
            kw["cluster"] = tkube.KubeCluster(
                tkube.KubeApi(server.url), worker_image="edl-tpu/worker:test")
        fn(**kw)
    finally:
        server.close()


# -- the two packages on one script ----------------------------------------------

REF = types.SimpleNamespace(kube=jkube, job=jjob, JobParser=JJobParser,
                            Controller=JController, Autoscaler=JAutoscaler,
                            pkg="edl_tpu")
PORT = types.SimpleNamespace(kube=tkube, job=tjob, JobParser=TJobParser,
                             Controller=TController, Autoscaler=TAutoscaler,
                             pkg="edl_tpu_torch")


def _manifest(name, lo, hi, chips, ft=True, ns="default"):
    return {"apiVersion": "edl-tpu.org/v1", "kind": "TrainingJob",
            "metadata": {"name": name, "namespace": ns},
            "spec": {"fault_tolerant": ft, "worker": {
                "entrypoint": "python train.py", "min_replicas": lo,
                "max_replicas": hi, "resources": {
                    "requests": {"cpu": "2", "memory": "4Gi", "tpu": chips},
                    "limits": {"tpu": chips}}}}}


def _store(server, pkg):
    """Every object the server holds, as JSON with sorted keys; the
    pods' commands name the module of ``pkg``, read as the reference's."""
    with server.state.lock:
        objs = {f"{gv}/{plural}": {f"{ns}/{name}": o
                                   for (ns, name), o in sorted(items.items())}
                for (gv, plural), items in server.state.objects.items()}
        text = json.dumps(objs, sort_keys=True)
    return text.replace(f'"{pkg}.runtime.', '"edl_tpu.runtime.')


def _manifest_script(m):
    """Worker groups (FT and not, with an accelerator type, volumes and
    spec env), coordinators, a retarget, a stale retarget, job census,
    the CRD source and status writes, deletions; returns the server's
    objects after each part and what the calls returned."""
    server = FakeKubeServer()
    out = []
    try:
        c = m.kube.KubeCluster(m.kube.KubeApi(server.url),
                               worker_image="edl-tpu/worker:test")
        for i in range(3):
            server.add_node(f"n{i}", cpu="96", memory="384Gi", tpu=8)
        parser = m.JobParser()
        job_mod = m.job
        for name, lo, hi, chips, ft in (("a", 2, 8, 4, True),
                                        ("rigid", 2, 2, 1, False),
                                        ("vol", 1, 4, 2, True)):
            job = job_mod.TrainingJob.from_dict(_manifest(name, lo, hi,
                                                          chips, ft))
            if name == "a":
                job.spec.accelerator_type = "v5e"
                job.spec.env = {"EDL_MODEL": "llama"}
            if name == "vol":
                job.spec.data_dir = "/data/ds"
                job.spec.volumes = [job_mod.VolumeSpec(
                    "dataset", {"persistentVolumeClaim": {"claimName": "ds"}})]
                job.spec.volume_mounts = [job_mod.VolumeMountSpec(
                    "dataset", "/data", read_only=True)]
            parser.validate(job)
            g = c.create_worker_group(parser.parse_to_workers(job))
            out.append([g.name, g.parallelism, g.resource_version])
            if ft:
                co = c.create_coordinator(parser.parse_to_coordinator(job))
                out.append([co.name, co.endpoint])
        server.reconcile_pods()
        out.append(_store(server, m.pkg))
        g = c.get_worker_group(job_mod.TrainingJob.from_dict(
            _manifest("a", 2, 8, 4)))
        g.parallelism = 5
        c.update_worker_group(g)
        try:
            c.update_worker_group(g)  # stale resource version
        except Exception as e:  # noqa: BLE001 — the error is the answer
            out.append([type(e).__name__, str(e)])
        server.reconcile_pods()
        r = c.inquiry_resource()
        out.append([r.chip_total, r.chip_request, r.cpu_request_milli,
                    r.mem_request_mega, sorted(r.hosts.chips_free.items())])
        for name in ("a", "rigid", "vol"):
            out.append(list(c.job_pods(job_mod.TrainingJob.from_dict(
                _manifest(name, 1, 2, 1)))))
        out.append([c.get_coordinator("default", "a-coordinator").endpoint])
        server.create_training_job(_manifest("tj", 1, 4, 1))
        for job in c.list_training_jobs():
            job.status.phase = job_mod.JobPhase.RUNNING
            job.status.parallelism = 3
            job.status.reshard_count = 2
            job.status.last_reshard_stall_s = 1.5
            c.update_training_job_status(job)
        c.delete_worker_group("default", "rigid-worker")
        c.delete_coordinator("default", "vol-coordinator")
        out.append(_store(server, m.pkg))
    finally:
        server.close()
    return out


def test_manifests_and_status_bodies_match_the_reference():
    ref, port = _manifest_script(REF), _manifest_script(PORT)
    assert port == ref
    assert '"edl_tpu.runtime.worker_main"' in ref[-1]


def test_pods_run_the_ports_modules():
    server = FakeKubeServer()
    try:
        c = tkube.KubeCluster(tkube.KubeApi(server.url))
        parser = TJobParser()
        job = tjob.TrainingJob.from_dict(_manifest("p", 1, 2, 1))
        parser.validate(job)
        c.create_worker_group(parser.parse_to_workers(job))
        c.create_coordinator(parser.parse_to_coordinator(job))
        w = server.get_object("batch/v1", "jobs", "default", "p-worker")
        d = server.get_object("apps/v1", "deployments", "default",
                              "p-coordinator")
    finally:
        server.close()
    assert w["spec"]["template"]["spec"]["containers"][0]["command"] == [
        "python", "-m", "edl_tpu_torch.runtime.worker_main"]
    assert d["spec"]["template"]["spec"]["containers"][0]["command"][:3] == [
        "python", "-m", "edl_tpu_torch.runtime.coordinator_main"]
    # the reference's data: GKE's TPU resource key and node label
    assert tkube.CHIP_RESOURCE_KEY == jkube.CHIP_RESOURCE_KEY == \
        "google.com/tpu"
    assert tkube.TPU_ACCELERATOR_NODE_LABEL == \
        jkube.TPU_ACCELERATOR_NODE_LABEL


def _seeded_manifests(n, seed):
    rng = np.random.RandomState(seed)
    out = []
    for i in range(n):
        lo = int(rng.randint(1, 5))
        hi = max(lo + 1, int(rng.randint(2, 17)))
        chips = int(rng.randint(1, 9))
        out.append(_manifest(f"job{i:02d}", lo, hi, chips))
    return out


def _kube_ticks(m, native, nodes=32, jobs=16, ticks=6):
    """``nodes`` x 8 chips, ``jobs`` seeded jobs, ``ticks`` control ticks
    of the kube loop (list-diff source, pods reconciled between ticks):
    each tick's targets, then each CRD's status."""
    server = FakeKubeServer()
    try:
        for i in range(nodes):
            server.add_node(f"n{i:03d}", cpu="96", memory="384Gi", tpu=8)
        for man in _seeded_manifests(jobs, 0):
            server.create_training_job(man)
        c = m.kube.KubeCluster(m.kube.KubeApi(server.url))
        a = m.Autoscaler(c, max_load_desired=0.97, use_native=native)
        ctl = m.Controller(c, autoscaler=a)
        src = m.kube.KubeJobSource(c, watch=False)
        out = []
        for _ in range(ticks):
            src.poll(ctl.on_add, ctl.on_update, ctl.on_delete)
            server.reconcile_pods()
            out.append(a.tick())
            ctl.step()
            for u in list(ctl.updaters.values()):
                c.update_training_job_status(u.job)
        with server.state.lock:
            crds = sorted(server.state.objects[("edl-tpu.org/v1",
                                                "trainingjobs")].items())
            statuses = {n: dict(o["status"]) for (_, n), o in crds}
        for st in statuses.values():
            # a wall-clock reading: only whether a reshard was timed
            st["last_reshard_stall_s"] = st["last_reshard_stall_s"] > 0
        out.append(statuses)
    finally:
        server.close()
    return out


@pytest.mark.parametrize("native", [False, True], ids=["python", "native"])
def test_kube_ticks_match_the_reference(native):
    ref = _kube_ticks(REF, native)
    port = _kube_ticks(PORT, native)
    assert port == ref
    assert any(t for t in ref[:-1]), "the fleet never retargeted"


def test_controller_kube_verb_writes_status_and_parallelism(monkeypatch):
    """``controller --kube --kube-url URL``: the CRD gets its status and
    the worker Job its parallelism; the verb exits 0."""
    from edl_tpu_torch.cli import main

    sources = []  # the verb leaves its watch thread running
    init = tkube.KubeJobSource.__init__

    def record(self, *a, **k):
        init(self, *a, **k)
        sources.append(self)

    monkeypatch.setattr(tkube.KubeJobSource, "__init__", record)
    server = FakeKubeServer()
    try:
        for i in range(2):
            server.add_node(f"n{i}", cpu="96", memory="384Gi", tpu=8)
        server.start_reconciler()
        server.create_training_job(_manifest("v", 1, 4, 1))
        rc = main(["controller", "--kube", "--kube-url", server.url,
                   "--tick-s", "0.01", "--iterations", "6",
                   "--max-load-desired", "0.9"])
        obj = server.get_object("edl-tpu.org/v1", "trainingjobs", "default",
                                "v")
        w = server.get_object("batch/v1", "jobs", "default", "v-worker")
    finally:
        for src in sources:
            src.close()
        server.close()
    assert rc == 0
    assert obj["status"]["phase"] in ("creating", "running", "scaling")
    assert w["spec"]["parallelism"] >= 1


def test_kube_check_phase_runs_on_the_cpu(capsys):
    """chip_smoke's kube_check phase with part (a) cut to 8 nodes and 6
    jobs over 3 ticks and part (c) to three harnesses: its row, gates
    and census."""
    chip_smoke.kube_check_phase(
        "cpu", c=dict(chip_smoke.KUBE_CHECK, nodes=8, jobs=6, iterations=3),
        harnesses=("pusher-backoff", "mut-pusher-backoff", "kube-rv"))
    row = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert row["phase"] == "kube_check"
    assert [r["planner"] for r in row["kube"]] == ["python", "native"]
    for r in row["kube"]:
        assert r["rc"] == 0 and len(r["ticks"]) == 3 and r["jobs"] == 6
        assert r["chips_requested"] <= r["chips_total"] == 64
        assert set(r["ticks"][0]) == {
            "poll_ms", "tick_ms", "step_ms", "status_ms", "status_writes",
            "pods", "chips_requested"}
    assert row["kube"][1]["native_plans"] > 0
    assert row["check"]["rc"] == 0 and row["check"]["files"] > 100
    assert row["check"]["baselined"] == 2
    sc = row["schedcheck"]
    assert sc["rc"] == 0 and set(sc["harnesses"]) == {
        "pusher-backoff", "mut-pusher-backoff", "kube-rv"}
    assert sc["harnesses"]["kube-rv"]["races"] > 0


def test_kube_check_gates_trip_on_planted_faults():
    good = {"planner": "native", "rc": 0, "native_plans": 3,
            "native_declined": 0, "statuses": {"a": "running"},
            "chips_requested": 10, "chips_total": 16, "jobs": 1}
    chip_smoke._kube_check_gate(good)
    for bad in ({"rc": 1}, {"native_plans": 0}, {"native_declined": 1},
                {"statuses": {"a": None}}, {"statuses": {}},
                {"chips_requested": 17}):
        with pytest.raises(AssertionError):
            chip_smoke._kube_check_gate({**good, **bad})
