"""edl_tpu_torch — the PyTorch/CUDA port of ``edl_tpu``.

The JAX package beside it is the reference; this package mirrors its
module paths and holds each ported module to it (tests/test_torch_*.py).
It imports torch and never jax, and nothing from ``edl_tpu``. Entry
points run on CUDA unless the caller passes ``device="cpu"``.

Ported so far: Llama serving through the continuous-batching engine
(``serving.engine``), with prefill attention on the hand-written Hopper
kernel ``ops/csrc/flash_fwd.cu``; one-card training of Llama, CTR,
fit_a_line, ResNet and BERT (``train.trainer``); exports and the
scoring consumer of every ported family (``runtime.export``,
``runtime.predict``); the elastic process runtime for dp meshes
(``runtime.launcher`` spawning ``runtime.worker_main`` processes that
regroup in place as workers join, drain or die), with the coordinator
process (``runtime.coordinator_main``) serving the job's aggregated
``/metrics``, ``/events`` and ``/trace`` and running the alert rules
(``obs.fleet``, ``obs.disttrace``, ``obs.alerts``). ``python -m
edl_tpu_torch VERB`` is the command-line entry: ``serve``,
``generate``, ``predict``, ``loadgen``, ``fleet`` and ``elasticity``,
the operator verbs ``top``, ``watch``, ``postmortem``, ``trace``,
``profile``, ``export-status`` and ``job-status``, the control-plane
verbs ``controller`` (``--kube``: ``cluster.kube``), ``submit``,
``delete``, ``list``, ``status``, ``monitor`` and ``validate``, and the
project's own checkers ``check`` and ``schedcheck`` (``analysis``).

The control plane — the ``TrainingJob`` API (``api``), the fake
cluster (``cluster``), the autoscaler and its native planner
(``scheduler``), the controller (``controller``), the Kubernetes
backend (``cluster.kube``), the checkers (``analysis``; the schedcheck
harnesses import the classes they drive when they run), the fleet
monitor (``monitor``) and the job store (``cli_store``) — and the in-process
coordinators with the lease/ack data queue (``runtime.coordinator``,
``runtime.data``, ``runtime.lease_table``) import no torch, and neither
does this package's top level: it re-exports the job API's names as
the reference's does.
"""

__version__ = "0.1.0"

from edl_tpu_torch.api.job import (  # noqa: F401
    JobPhase,
    MasterSpec,
    PserverSpec,
    ResourceRequirements,
    ResourceSpec,
    TrainingJob,
    TrainingJobSpec,
    TrainingJobStatus,
    WorkerSpec,
)
from edl_tpu_torch.api.parser import JobParser  # noqa: F401
