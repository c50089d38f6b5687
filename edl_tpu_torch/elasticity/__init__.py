"""Train⇄serve chip elasticity: lease-brokered inventory + the
diurnal handover policy loop — the port of ``edl_tpu/elasticity``.

The paper's control plane continuously re-targets jobs between min and
max instances as cluster load shifts; this package is the fusion of
the repo's two independently-elastic sides. :mod:`broker` owns the
chip inventory as first-class leases (GRANTED→RECALLING→FREED, epochs
monotonic), :mod:`distbroker` is the same contract fronted by the
coordinator (WAL-persisted leases, epoch fencing, broker-restart
recovery), :mod:`controller` is the policy loop that recalls from one
side and grants to the other through the autoscaler's shared
hysteresis gate, and :mod:`weightpush` is the p2p warm-start plane
that lets a freshly granted serving replica pull live weights over
the shard-server protocol instead of cold-loading an export.
"""

from edl_tpu_torch.elasticity.broker import (  # noqa: F401
    FREED,
    GRANTED,
    RECALLING,
    ChipLeaseBroker,
    Lease,
    LeaseError,
)
from edl_tpu_torch.elasticity.controller import (  # noqa: F401
    ElasticityController,
    ServePort,
    TrainPort,
)
from edl_tpu_torch.elasticity.distbroker import (  # noqa: F401
    DistributedChipBroker,
)
