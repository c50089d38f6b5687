"""ClusterResource — the fleet census the autoscaler plans against.

TPU port of the reference's ClusterResource (reference: pkg/cluster.go:32-61):
GPU fields become chip fields (chips are limit-accounted, exclusively
allocated), CPU/memory stay request-accounted, and the per-node idle maps
gain a free-chip map so worker placement is chip-aware
(reference: searchAssignableNode only checks CPU+mem, pkg/autoscaler.go:191-199).

The port of ``edl_tpu/cluster/resource.py``, unchanged in behaviour; it imports
no torch.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict


@dataclass
class Hosts:
    """Per-host idle capacity (reference: Nodes, pkg/cluster.go:51-56).

    ``ici_block``/``ici_index`` describe physical slice topology: hosts
    sharing a block are on one ICI domain (a TPU pod), ordered by index
    along the torus host dimension. Multi-host ICI placements must be
    index-aligned contiguous windows WITHIN one block (the sub-slice
    carving rule); hosts without block info are DCN-reachable only.
    The reference has no analog — its per-node idle maps are flat
    (pkg/cluster.go:51-56) because CPU placement has no contiguity.
    """

    cpu_idle_milli: Dict[str, int] = field(default_factory=dict)
    mem_free_mega: Dict[str, int] = field(default_factory=dict)
    chips_free: Dict[str, int] = field(default_factory=dict)
    ici_block: Dict[str, str] = field(default_factory=dict)
    ici_index: Dict[str, int] = field(default_factory=dict)


@dataclass
class ClusterResource:
    """Fleet totals + currently-accounted requests/limits.

    Chip fields mirror the reference's GPU trio (GPUTotal/GPULimit/
    GPURequest, pkg/cluster.go:34-37): ``chip_limit`` is the planning
    quantity (chips are exclusive, request==limit).
    """

    chip_total: int = 0
    chip_limit: int = 0
    chip_request: int = 0

    cpu_total_milli: int = 0
    cpu_limit_milli: int = 0
    cpu_request_milli: int = 0

    mem_total_mega: int = 0
    mem_limit_mega: int = 0
    mem_request_mega: int = 0

    hosts: Hosts = field(default_factory=Hosts)

    def copy(self) -> "ClusterResource":
        return ClusterResource(
            chip_total=self.chip_total,
            chip_limit=self.chip_limit,
            chip_request=self.chip_request,
            cpu_total_milli=self.cpu_total_milli,
            cpu_limit_milli=self.cpu_limit_milli,
            cpu_request_milli=self.cpu_request_milli,
            mem_total_mega=self.mem_total_mega,
            mem_limit_mega=self.mem_limit_mega,
            mem_request_mega=self.mem_request_mega,
            hosts=Hosts(
                cpu_idle_milli=dict(self.hosts.cpu_idle_milli),
                mem_free_mega=dict(self.hosts.mem_free_mega),
                chips_free=dict(self.hosts.chips_free),
                ici_block=dict(self.hosts.ici_block),
                ici_index=dict(self.hosts.ici_index),
            ),
        )
