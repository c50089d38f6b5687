"""Load generator — seeded arrival-process workloads for the serving
engine, replayed wall-clock.

``scripts/exp_serving.py`` replays a fixed step-indexed feed, which
measures the ENGINE but not the QUEUE: production traffic is bursty
(arrivals cluster), heavy-tailed (a few prompts/outputs dominate the
token budget), and multi-tenant (classes with different latency
contracts share the slots). Sarathi-Serve (OSDI '24) shows tail
TTFT/ITL under exactly this load is where batched engines fall over —
so this module generates it reproducibly:

* **arrival processes** — ``poisson`` (exponential inter-arrivals),
  ``burst`` (a two-state Markov-modulated Poisson process: calm rate
  vs ``burst_factor``× rate, exponential state dwell — arrivals
  cluster the way real traffic does), ``fixed`` (deterministic
  spacing, the closed-loop baseline);
* **heavy-tailed lengths** — log-normal prompt/output draws, clipped
  to per-tenant bounds (the tail exists, the engine's admission
  control still holds);
* **tenants and SLO classes** — each request carries ``tenant`` and
  ``slo_class`` (obs/slo.py ``SLOClass``: ``ttft_slo_s`` +
  ``itl_slo_s``), so the goodput report can answer "which tenant got
  shed".

Everything is driven by one ``numpy.random.RandomState(seed)`` whose
draw order is fixed: **the same seed produces a byte-identical
workload** (``workload_jsonl`` — the CI determinism gate in
``scripts/run_tests.sh``). torch-free on purpose: generation and replay
pacing are host work; only the engine passed to :func:`replay`
touches a device.

The step-indexed builder the soak harness and bench use
(:func:`step_indexed_workload`) lives here too, so the three load
surfaces (soak, bench, loadgen) share one generator instead of
drifting apart.

The PyTorch port's copy of ``edl_tpu/serving/loadgen.py``: the same
seed draws the same numpy stream, so a workload's JSONL is the
reference's byte for byte.
"""

from __future__ import annotations

import json
import math
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

import numpy as np

from edl_tpu_torch.obs.slo import SLOClass, classes_by_name, default_classes
from edl_tpu_torch.serving.scheduler import AdmissionError

__all__ = [
    "TenantSpec",
    "WorkloadSpec",
    "GenRequest",
    "default_tenants",
    "build",
    "workload_jsonl",
    "replay",
    "step_indexed_workload",
]

ARRIVALS = ("poisson", "burst", "fixed")


@dataclass(frozen=True)
class TenantSpec:
    """One tenant's slice of the mix: its traffic share, its SLO
    class, and its length distributions (log-normal around the mean,
    clipped to [1, max] — the bounds keep prompt + budget inside the
    engine's KV slot, so admission never rejects by construction)."""

    name: str
    weight: float = 1.0
    slo_class: str = "interactive"
    prompt_mean: int = 8
    prompt_max: int = 24
    output_mean: int = 12
    output_max: int = 24
    prompt_sigma: float = 0.6  # log-space spread: the heavy tail
    output_sigma: float = 0.8


def default_tenants() -> Tuple[TenantSpec, ...]:
    """A three-tenant mix sized for the CPU-dryrun engine shapes
    (prompt_max + output_max <= 96): a chatty interactive majority,
    a long-output batch tenant, and a long-prompt interactive tail."""
    return (
        TenantSpec("acme", weight=0.6, slo_class="interactive",
                   prompt_mean=8, prompt_max=24,
                   output_mean=10, output_max=24),
        TenantSpec("batchco", weight=0.25, slo_class="batch",
                   prompt_mean=16, prompt_max=40,
                   output_mean=24, output_max=48),
        TenantSpec("tailco", weight=0.15, slo_class="interactive",
                   prompt_mean=24, prompt_max=48,
                   output_mean=6, output_max=12),
    )


@dataclass(frozen=True)
class WorkloadSpec:
    """Everything :func:`build` needs — hashable, explicit, and fully
    determined by ``seed`` (two specs that compare equal generate
    byte-identical workloads)."""

    seed: int = 0
    n_requests: int = 64
    rate_rps: float = 8.0
    arrival: str = "poisson"  # poisson | burst | fixed
    burst_factor: float = 4.0  # burst-state rate multiplier (MMPP)
    burst_dwell_s: float = 1.0  # mean dwell per MMPP state
    vocab: int = 512
    # shared-prefix traffic (paged-KV prefix cache measurement): each
    # tenant gets one fixed system-prompt template of
    # ``shared_prefix_len`` tokens; with probability
    # ``shared_prefix_frac`` a request's leading prompt tokens are
    # REPLACED by its tenant's template. 0.0 (the default) draws
    # NOTHING extra from the rng — specs without the knob stay
    # byte-identical to pre-knob builds (the CI cmp gate).
    shared_prefix_frac: float = 0.0
    shared_prefix_len: int = 12
    # repetitive-prompt traffic (speculative-decoding measurement):
    # with probability ``repetition_frac`` a request's prompt is
    # REPLACED by a short random pattern of ``repetition_len`` tokens
    # tiled to the drawn prompt length — structured/templated traffic
    # the n-gram drafter can actually predict. 0.0 (the default) draws
    # NOTHING extra from the rng: pre-knob workloads stay
    # byte-identical (the CI cmp gate).
    repetition_frac: float = 0.0
    repetition_len: int = 4
    tenants: Tuple[TenantSpec, ...] = field(default_factory=default_tenants)
    classes: Tuple[SLOClass, ...] = field(default_factory=default_classes)

    def class_map(self) -> Dict[str, SLOClass]:
        return classes_by_name(self.classes)


@dataclass
class GenRequest:
    """One generated request: identity + arrival offset + payload +
    the SLO contract it will be judged against."""

    rid: str
    arrive_s: float
    tenant: str
    slo_class: str
    prompt: List[int]
    max_new: int
    ttft_slo_s: float
    itl_slo_s: float

    def to_record(self) -> Dict[str, Any]:
        return {
            "rid": self.rid,
            "arrive_s": self.arrive_s,
            "tenant": self.tenant,
            "slo_class": self.slo_class,
            "prompt": list(self.prompt),
            "max_new": self.max_new,
            "ttft_slo_s": self.ttft_slo_s,
            "itl_slo_s": self.itl_slo_s,
        }


# ---------------------------------------------------------------------------
# generation


def _arrival_times(spec: WorkloadSpec, rng: np.random.RandomState) -> List[float]:
    """``n_requests`` arrival offsets (seconds from t=0), one draw
    sequence per process so the arrival stream is independent of the
    payload draws only in MEANING — the shared RandomState keeps the
    whole workload one deterministic stream."""
    if spec.rate_rps <= 0:
        raise ValueError(f"rate_rps must be > 0, got {spec.rate_rps}")
    if spec.arrival not in ARRIVALS:
        raise ValueError(
            f"arrival must be one of {ARRIVALS}, got {spec.arrival!r}"
        )
    n = spec.n_requests
    t = 0.0
    out: List[float] = []
    if spec.arrival == "fixed":
        gap = 1.0 / spec.rate_rps
        for i in range(n):
            out.append(round(i * gap, 6))
        return out
    if spec.arrival == "poisson":
        for _ in range(n):
            t += float(rng.exponential(1.0 / spec.rate_rps))
            out.append(round(t, 6))
        return out
    # burst: two-state MMPP. State dwell times are exponential with
    # mean burst_dwell_s; the burst state multiplies the rate. The
    # calm-state rate is scaled down so the LONG-RUN mean rate stays
    # rate_rps (bursts redistribute arrivals, they don't add traffic).
    mean_mult = (1.0 + spec.burst_factor) / 2.0
    calm = spec.rate_rps / mean_mult
    hot = calm * spec.burst_factor
    state_rate = calm
    state_until = float(rng.exponential(spec.burst_dwell_s))
    while len(out) < n:
        gap = float(rng.exponential(1.0 / state_rate))
        if t + gap >= state_until:
            # jump to the state boundary and flip states; the partial
            # gap re-draws under the new rate (memorylessness makes
            # this exact for the exponential)
            t = state_until
            state_rate = hot if state_rate == calm else calm
            state_until = t + float(rng.exponential(spec.burst_dwell_s))
            continue
        t += gap
        out.append(round(t, 6))
    return out


def _lognormal_int(
    rng: np.random.RandomState, mean: int, sigma: float, lo: int, hi: int
) -> int:
    """Heavy-tailed positive int around ``mean``: log-normal with
    median ``mean``, clipped to [lo, hi]."""
    v = float(rng.lognormal(math.log(max(mean, 1)), sigma))
    return int(min(max(int(round(v)), lo), hi))


def _pick_tenant(
    rng: np.random.RandomState, tenants: Tuple[TenantSpec, ...]
) -> TenantSpec:
    total = sum(t.weight for t in tenants)
    u = float(rng.uniform(0.0, total))
    acc = 0.0
    for t in tenants:
        acc += t.weight
        if u <= acc:
            return t
    return tenants[-1]


def build(spec: WorkloadSpec) -> List[GenRequest]:
    """Generate the workload. Deterministic: one RandomState seeded
    from ``spec.seed``, fixed draw order (arrivals first, then per
    request: tenant, prompt length, prompt tokens, output length)."""
    if not spec.tenants:
        raise ValueError("spec.tenants must be non-empty")
    cmap = spec.class_map()
    missing = {t.slo_class for t in spec.tenants} - set(cmap)
    if missing:
        raise ValueError(f"tenants reference unknown SLO classes {sorted(missing)}")
    if not 0.0 <= spec.shared_prefix_frac <= 1.0:
        raise ValueError(
            f"shared_prefix_frac must be in [0, 1], got "
            f"{spec.shared_prefix_frac}"
        )
    if spec.shared_prefix_len < 1:
        raise ValueError(
            f"shared_prefix_len must be >= 1, got {spec.shared_prefix_len}"
        )
    if not 0.0 <= spec.repetition_frac <= 1.0:
        raise ValueError(
            f"repetition_frac must be in [0, 1], got {spec.repetition_frac}"
        )
    if spec.repetition_len < 1:
        raise ValueError(
            f"repetition_len must be >= 1, got {spec.repetition_len}"
        )
    rng = np.random.RandomState(spec.seed)
    arrivals = _arrival_times(spec, rng)
    # per-tenant system-prompt templates, drawn ONCE and only when the
    # knob is on — the frac=0 path's draw sequence is untouched, so
    # pre-knob workloads reproduce byte-for-byte
    templates: Dict[str, List[int]] = {}
    if spec.shared_prefix_frac > 0:
        for t in spec.tenants:
            templates[t.name] = [
                int(x)
                for x in rng.randint(0, spec.vocab, spec.shared_prefix_len)
            ]
    reqs: List[GenRequest] = []
    for i, at in enumerate(arrivals):
        t = _pick_tenant(rng, spec.tenants)
        plen = _lognormal_int(rng, t.prompt_mean, t.prompt_sigma, 1, t.prompt_max)
        prompt = rng.randint(0, spec.vocab, plen).tolist()
        max_new = _lognormal_int(rng, t.output_mean, t.output_sigma, 1, t.output_max)
        if spec.shared_prefix_frac > 0:
            # the extra draw happens ONLY behind the gate, after the
            # existing per-request draws — draw-order stability
            if float(rng.rand()) < spec.shared_prefix_frac:
                tpl = templates[t.name]
                # keep at least one tenant-specific trailing token so
                # identical-template requests still diverge
                k = min(len(tpl), max(plen - 1, 0))
                prompt[:k] = tpl[:k]
        if spec.repetition_frac > 0:
            # same draw-order rule as shared_prefix: the extra draws
            # sit behind the gate, AFTER every existing per-request
            # draw, so frac=0 builds reproduce byte-for-byte
            if float(rng.rand()) < spec.repetition_frac:
                period = min(spec.repetition_len, plen)
                pat = [int(x) for x in rng.randint(0, spec.vocab, period)]
                prompt = (pat * (plen // period + 1))[:plen]
        c = cmap[t.slo_class]
        reqs.append(
            GenRequest(
                rid=f"lg-{i:05d}",
                arrive_s=at,
                tenant=t.name,
                slo_class=t.slo_class,
                prompt=[int(x) for x in prompt],
                max_new=max_new,
                ttft_slo_s=c.ttft_slo_s,
                itl_slo_s=c.itl_slo_s,
            )
        )
    return reqs


def workload_jsonl(reqs: Iterable[GenRequest]) -> str:
    """Byte-stable serialization (sorted keys, no whitespace): the
    same seed MUST produce the same bytes — CI compares two runs with
    ``cmp``."""
    return "\n".join(
        json.dumps(r.to_record(), sort_keys=True, separators=(",", ":"))
        for r in reqs
    ) + "\n"


def max_total_len(reqs: Iterable[GenRequest]) -> int:
    """The KV-slot length this workload needs (prompt + budget)."""
    return max((len(r.prompt) + r.max_new for r in reqs), default=2)


# ---------------------------------------------------------------------------
# wall-clock replay


def replay(
    engine: Any,
    reqs: List[GenRequest],
    *,
    speed: float = 1.0,
    clock: Callable[[], float] = time.monotonic,
    sleep: Callable[[float], None] = time.sleep,
    on_tick: Optional[Callable[[], None]] = None,
    tick_every: int = 8,
    max_wall_s: Optional[float] = None,
) -> Dict[str, float]:
    """Replay a workload against a live engine on the wall clock:
    each request submits when its ``arrive_s`` offset comes due (at
    ``speed``× real time), the engine steps whenever it has work, and
    the loop sleeps only when idle before the next arrival. Admission
    rejections (queue full, expired deadlines) are COUNTED, not fatal
    — shed load is data, and the metrics/goodput layers account for
    it. ``on_tick`` fires every ``tick_every`` engine steps (the live
    SLO-gauge refresh hook). Returns wall/step/submit accounting."""
    if speed <= 0:
        raise ValueError(f"speed must be > 0, got {speed}")
    ordered = sorted(reqs, key=lambda r: (r.arrive_s, r.rid))
    t0 = clock()
    i = 0
    steps = 0
    submitted = 0
    rejected = 0
    while i < len(ordered) or engine.has_work:
        now = (clock() - t0) * speed
        if max_wall_s is not None and clock() - t0 > max_wall_s:
            break
        while i < len(ordered) and ordered[i].arrive_s <= now:
            r = ordered[i]
            i += 1
            try:
                engine.submit(
                    r.rid, r.prompt, r.max_new,
                    tenant=r.tenant, slo_class=r.slo_class,
                )
                submitted += 1
            except AdmissionError:
                rejected += 1  # typed + counted by the metrics layer
        if engine.has_work:
            engine.step()
            steps += 1
            if on_tick is not None and steps % max(1, tick_every) == 0:
                on_tick()
        elif i < len(ordered):
            dt = (ordered[i].arrive_s - now) / speed
            sleep(min(max(dt, 0.0), 0.05))
    if on_tick is not None:
        on_tick()
    return {
        "wall_s": clock() - t0,
        "steps": float(steps),
        "submitted": float(submitted),
        "rejected": float(rejected),
    }


# ---------------------------------------------------------------------------
# the step-indexed builder (soak harness + bench)


def step_indexed_workload(
    n_requests: int,
    vocab: int,
    rng: np.random.RandomState,
    *,
    prompt_range: Tuple[int, int],
    max_new_range: Tuple[int, int],
    max_gap: int = 4,
) -> List[Dict[str, Any]]:
    """Mixed-length prompts/budgets with STEP-indexed arrivals
    (request i joins at engine iteration ``arrive[i]``) — the
    reproducible-regardless-of-wall-clock form ``exp_serving.py`` and
    ``bench.py`` replay. Draw order is pinned (prompt len, budget,
    prompt tokens, gap per request): these are the bytes the existing
    dispatch-bound CI assertions were tuned on."""
    reqs: List[Dict[str, Any]] = []
    step = 0
    for i in range(n_requests):
        t0 = int(rng.randint(prompt_range[0], prompt_range[1]))
        max_new = int(rng.randint(max_new_range[0], max_new_range[1]))
        prompt = rng.randint(0, vocab, t0).tolist()
        reqs.append(
            {"rid": f"r{i}", "prompt": prompt, "max_new": max_new,
             "arrive": step}
        )
        # bursty arrivals: some requests land together, some trickle
        step += int(rng.randint(0, max_gap))
    return reqs
