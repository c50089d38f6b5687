"""Resource quantities and arithmetic.

TPU-native resource model. The reference accounts CPU/memory/GPU via k8s
``resource.Quantity`` maps (reference: pkg/cluster.go:32-61, pkg/utils.go:23-34).
Here the accelerator is TPU chips — an integral, exclusively-allocated
resource (like the reference's GPU *limit* accounting,
reference: pkg/autoscaler.go:39-42) — while host CPU (milli-cores) and
memory (MB) stay divisible request-style resources.

The port of ``edl_tpu/api/resources.py``, unchanged in behaviour; it imports
no torch.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from fractions import Fraction
from typing import Dict, Mapping, Union

# Decimal and binary suffixes accepted by parse_quantity, as exact
# multipliers (k8s resource.Quantity grammar subset).
_SUFFIX = {
    "": Fraction(1),
    "m": Fraction(1, 1000),
    "k": Fraction(10**3),
    "M": Fraction(10**6),
    "G": Fraction(10**9),
    "T": Fraction(10**12),
    "Ki": Fraction(2**10),
    "Mi": Fraction(2**20),
    "Gi": Fraction(2**30),
    "Ti": Fraction(2**40),
}

_QTY_RE = re.compile(r"^\s*([0-9]*\.?[0-9]+)\s*([a-zA-Z]*)\s*$")


def _parse_exact(value: Union[str, int, float]) -> Fraction:
    if isinstance(value, int):
        return Fraction(value)
    if isinstance(value, float):
        return Fraction(str(value))
    m = _QTY_RE.match(value)
    if not m:
        raise ValueError(f"invalid quantity: {value!r}")
    num, suffix = m.groups()
    if suffix not in _SUFFIX:
        raise ValueError(f"invalid quantity suffix: {value!r}")
    return Fraction(num) * _SUFFIX[suffix]


def parse_quantity(value: Union[str, int, float]) -> float:
    """Parse a k8s-style quantity string ("200m", "1k", "100Mi") to a float
    in base units. Mirrors the subset of ``resource.ParseQuantity`` the
    reference exercises (reference: pkg/autoscaler_internal_test.go:56-77).
    """
    return float(_parse_exact(value))


def cpu_milli(value: Union[str, int, float]) -> int:
    """CPU quantity → integer milli-cores, rounding up (Go
    ``Quantity.ScaledValue(resource.Milli)`` semantics: "1k" → 1_000_000).
    Exact (Fraction) arithmetic so "700m" is 700, never 701."""
    raw = _parse_exact(value) * 1000
    return -((-raw.numerator) // raw.denominator)


def mem_mega(value: Union[str, int, float]) -> int:
    """Memory quantity → integer megabytes (1e6), rounding up (Go
    ``ScaledValue(resource.Mega)`` semantics: "100Mi" → 105)."""
    raw = _parse_exact(value) / 10**6
    return -((-raw.numerator) // raw.denominator)


def chip_count(value: Union[str, int, float]) -> int:
    """TPU chip quantity → int. Chips are integral and exclusively
    allocated; fractional values are a spec error, not a truncation."""
    raw = _parse_exact(value)
    if raw.denominator != 1 or raw < 0:
        raise ValueError(f"tpu chips must be a non-negative integer, got {value!r}")
    return int(raw)


@dataclass
class ResourceSpec:
    """Per-replica resource ask.

    ``tpu_chips`` replaces the reference's ``alpha.kubernetes.io/nvidia-gpu``
    limit (reference: pkg/resource/training_job.go:194-207). Chips are
    exclusive: request == limit by construction.
    """

    cpu_milli: int = 0
    mem_mega: int = 0
    tpu_chips: int = 0

    @classmethod
    def parse(cls, d: Mapping) -> "ResourceSpec":
        """Parse a ``{cpu:, memory:, tpu:}`` mapping with k8s quantities."""
        if d is None:
            return cls()
        return cls(
            cpu_milli=cpu_milli(d.get("cpu", 0)),
            mem_mega=mem_mega(d.get("memory", 0)),
            tpu_chips=chip_count(d.get("tpu", d.get("tpu_chips", 0))),
        )

    def __add__(self, other: "ResourceSpec") -> "ResourceSpec":
        return ResourceSpec(
            self.cpu_milli + other.cpu_milli,
            self.mem_mega + other.mem_mega,
            self.tpu_chips + other.tpu_chips,
        )

    def scaled(self, n: int) -> "ResourceSpec":
        return ResourceSpec(self.cpu_milli * n, self.mem_mega * n, self.tpu_chips * n)

    def to_dict(self) -> Dict[str, Union[str, int]]:
        """Canonical-quantity mapping; inverse of parse (zeros omitted)."""
        out: Dict[str, Union[str, int]] = {}
        if self.cpu_milli:
            out["cpu"] = f"{self.cpu_milli}m"
        if self.mem_mega:
            out["memory"] = f"{self.mem_mega}M"
        if self.tpu_chips:
            out["tpu"] = self.tpu_chips
        return out


@dataclass
class ResourceRequirements:
    """requests/limits pair (reference: corev1.ResourceRequirements usage at
    pkg/apis/paddlepaddle/v1/types.go:72-90)."""

    requests: ResourceSpec = field(default_factory=ResourceSpec)
    limits: ResourceSpec = field(default_factory=ResourceSpec)

    @classmethod
    def parse(cls, d: Mapping) -> "ResourceRequirements":
        if d is None:
            return cls()
        return cls(
            requests=ResourceSpec.parse(d.get("requests")),
            limits=ResourceSpec.parse(d.get("limits")),
        )

    def to_dict(self) -> Dict[str, Dict]:
        out: Dict[str, Dict] = {}
        if self.requests.to_dict():
            out["requests"] = self.requests.to_dict()
        if self.limits.to_dict():
            out["limits"] = self.limits.to_dict()
        return out


def add_resource_list(dst: Dict[str, float], src: Mapping[str, float]) -> None:
    """Accumulate a resource map into ``dst`` in place
    (reference: pkg/utils.go:23-34 ``AddResourceList``)."""
    for k, v in src.items():
        dst[k] = dst.get(k, 0) + v
