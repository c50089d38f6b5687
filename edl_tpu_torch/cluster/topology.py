"""TPU slice topology — the accelerator-shape knowledge the scheduler needs.

The reference bin-packs per-node CPU/mem/GPU (reference: pkg/cluster.go:32-61,
pkg/autoscaler.go:191-199). On TPU the unit is a *chip* living on a host
that belongs to a pod slice; multi-host jobs want ICI-contiguous worker
counts. This module encodes chips-per-host per accelerator family and
slice-shape legality policies.

The port of ``edl_tpu/cluster/topology.py``, unchanged in behaviour; it imports
no torch.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List


@dataclass(frozen=True)
class AcceleratorFamily:
    """Static facts about one TPU generation."""

    name: str
    chips_per_host: int  # chips driven by one worker process/host VM
    ici_degree: int  # ICI links per chip (torus dimensionality * 2)


FAMILIES: Dict[str, AcceleratorFamily] = {
    "v4": AcceleratorFamily("v4", 4, 6),
    "v5e": AcceleratorFamily("v5e", 4, 4),
    "v5p": AcceleratorFamily("v5p", 4, 6),
    "v6e": AcceleratorFamily("v6e", 4, 4),
    "cpu": AcceleratorFamily("cpu", 0, 0),  # host-only jobs (fit_a_line local)
}


def family(name: str) -> AcceleratorFamily:
    try:
        return FAMILIES[name]
    except KeyError:
        raise ValueError(f"unknown accelerator family {name!r}") from None


# --- slice-shape legality policies ------------------------------------------
#
# The autoscaler proposes worker-count deltas of ±1 (reference:
# pkg/autoscaler.go:201-291). A SlicePolicy decides whether a proposed
# worker count is a legal slice shape; illegal counts are skipped over
# in the direction of travel.

SlicePolicy = Callable[[int], bool]


def flexible(n: int) -> bool:
    """Any worker count (DCN-connected hosts / multislice). Matches the
    reference's unconstrained Parallelism."""
    return n >= 0


def pow2(n: int) -> bool:
    """ICI-contiguous slices: worker counts restricted to powers of two
    (v5e pod slices: 1,2,4,8,... hosts). Zero is not a slice shape."""
    return n >= 1 and (n & (n - 1)) == 0


@dataclass(frozen=True)
class SliceShapePolicy:
    """Catalog-backed slice legality for one accelerator family: worker
    (host) counts must be powers of two, bounded by the family's largest
    pod (derived from its torus dimensionality — ``ici_degree``/2 axes:
    2D v5e/v6e pods top out at 16x16 chips = 64 hosts, 3D v4/v5p cubes
    at 16x16x16 = 1024 hosts), and multi-host placements must be
    index-aligned contiguous windows within ONE physical block
    (``contiguous``). Instances are native-expressible: the C++ planner
    mirrors (kind, cap, contiguous) exactly."""

    family: str
    cap: int  # max hosts in one slice (largest pod of the family)
    # Contiguity is enforced PER GROW STEP: each step's new workers must
    # form one aligned window in one block. Joint contiguity with the
    # job's EXISTING workers is not enforceable from the capacity-only
    # census (resource.Hosts carries free capacity, not placements) — a
    # 2->4 growth can land the new pair in a different pod. Closing that
    # requires the census to carry per-job host assignments.
    contiguous: bool = True

    @property
    def name(self) -> str:
        return f"slice:{self.family}"

    def __call__(self, n: int) -> bool:
        return pow2(n) and n <= self.cap


# Largest pod per torus dimensionality, in HOSTS (4 chips/host):
# 2D (ici_degree 4): 16x16 chips = 256 chips = 64 hosts (v5e/v6e pods);
# 3D (ici_degree 6): 16x16x16 chips = 4096 chips = 1024 hosts (v4/v5p).
_SLICE_HOST_CAP = {2: 64, 3: 1024}


def slice_policy(family_name: str) -> SliceShapePolicy:
    fam = family(family_name)
    dims = fam.ici_degree // 2
    if dims not in _SLICE_HOST_CAP:
        raise ValueError(
            f"family {family_name!r} has no ICI torus (degree {fam.ici_degree})"
        )
    return SliceShapePolicy(family=fam.name, cap=_SLICE_HOST_CAP[dims])


def slice_host_counts(family_name: str) -> List[int]:
    """The family's legal slice catalog, in hosts."""
    p = slice_policy(family_name)
    return [n for n in range(1, p.cap + 1) if p(n)]


def topology_name(family_name: str, hosts: int) -> str:
    """Chip-grid name of a slice (e.g. v5e 8 hosts -> "4x8"), for
    observability; "" when the count is not in the family's catalog
    (or the family has no ICI torus at all)."""
    fam = family(family_name)
    if fam.ici_degree < 4:
        return ""
    p = slice_policy(family_name)
    if not p(hosts):
        return ""
    chips = hosts * fam.chips_per_host
    dims = fam.ici_degree // 2
    # split chips into `dims` pow2 factors, as square as possible,
    # ascending — the canonical shapes (v5e: 2x2, 2x4, 4x4, 4x8, ...)
    shape = [1] * dims
    while chips > 1:
        shape[shape.index(min(shape))] *= 2
        chips //= 2
    return "x".join(str(s) for s in sorted(shape))


def policy_for_job(accelerator_type: str, chips_per_worker: int) -> SlicePolicy:
    """Per-job slice legality from the job's own accelerator type
    (reference analog surpassed: one global searchAssignableNode rule,
    pkg/autoscaler.go:191-199). Chip-less jobs and families without an
    ICI torus place flexibly over DCN."""
    fam = FAMILIES.get(accelerator_type)
    if fam is None or chips_per_worker <= 0 or fam.ici_degree < 4:
        return flexible
    return slice_policy(accelerator_type)


POLICIES: Dict[str, SlicePolicy] = {"flexible": flexible, "pow2": pow2}


def next_legal(n: int, direction: int, policy: SlicePolicy, lo: int, hi: int) -> int:
    """Nearest legal count moving from ``n`` by ``direction`` (±1), clamped
    to [lo, hi]. A count outside the range jumps to the range edge first
    (so a job below its min can climb into range). Returns ``n`` when no
    legal count exists in range."""
    cur = n + direction
    if direction > 0 and cur < lo:
        cur = lo
    if direction < 0 and cur > hi:
        cur = hi
    while lo <= cur <= hi:
        if policy(cur):
            return cur
        cur += direction
    return n


def floor_legal(n: int, policy: SlicePolicy, lo: int, hi: int) -> int:
    """Largest legal count ≤ min(n, hi) and ≥ lo; ``n`` if none exists."""
    cur = min(n, hi)
    while cur >= lo:
        if policy(cur):
            return cur
        cur -= 1
    return n


def legal_counts(policy: SlicePolicy, lo: int, hi: int) -> List[int]:
    return [n for n in range(lo, hi + 1) if policy(n)]
