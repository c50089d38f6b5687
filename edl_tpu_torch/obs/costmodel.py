"""Analytic hardware cost model — the port's copy of
``edl_tpu/obs/costmodel.py``: the one source of FLOPs and bytes truth
for ``chip_smoke.py``'s bounds and MFU, ``models/llama.py``'s
``train_flops_per_token`` and the LIVE efficiency gauges
(``edl_mfu{phase}`` / ``edl_bw_util_ratio{phase}``) the serving engine
publishes through :class:`EfficiencyMeter`.

torch-free at module scope: config objects are duck typed — anything
with ``vocab / d_model / n_layers / n_heads / n_kv_heads / d_ff`` works
(``LlamaConfig``); CTR has its own entry point. :func:`detect_peak`
imports torch lazily, only when asked for a device.

**Peaks are the card's.** The table holds NVIDIA's H100 datasheet
figures (dense bf16, HBM): SXM ("NVIDIA H100 80GB HBM3") 989 TF/s at
3.35 TB/s, PCIe 756 TF/s at 2.0 TB/s. There is no hidden fallback: a
CUDA card the table does not name raises unless ``EDL_PEAK_TFLOPS``
and ``EDL_PEAK_HBM_GBS`` give its peaks, and those overrides apply on
top of a named card as in the reference. The CPU (tests only) gets the
SXM row, labelled as assumed, so CPU gauges stay tiny but nonzero.

FLOPs conventions (the reference's):

* **train**: model FLOPs per token = ``6 × matmul params`` (embedding
  lookup excluded, lm_head included) + causal attention
  ``12·L·(T/2)·d_attn``. Remat recompute is NOT counted (MFU counts
  model FLOPs, not hardware FLOPs).
* **prefill**: the forward third of the above over the prompt.
* **decode**: per token at context ``s``, ``2 × matmul params`` +
  ``4·L·s·d_attn``. The serving decode computes masked-DENSE attention
  over the full padded cache, so the per-step cost uses the FULL padded
  length, not the average occupancy — the cost of the work the card
  actually runs.

Bytes conventions: a decode step must move every parameter byte (the
weight stream — the defining cost of small-batch decode) plus the full
padded KV cache; activation traffic at serving batch sizes is noise
next to those two.
"""

from __future__ import annotations

import os
import threading
from dataclasses import dataclass
from typing import Any, Dict, Optional

from edl_tpu_torch.obs import metrics as obs_metrics

# ---------------------------------------------------------------------------
# device peaks


@dataclass(frozen=True)
class DevicePeak:
    """Per-card peak rates: dense bf16 FLOP/s and HBM bandwidth.
    Spec-sheet values — read achieved/peak as a relative efficiency
    index."""

    kind: str
    flops: float  # bf16 dense peak FLOP/s
    hbm_bytes_s: float  # peak HBM bytes/s


# ordered substring table over torch.cuda.get_device_name — first match
# wins (NVIDIA H100 datasheet); the PCIe row is matched first
_PEAK_TABLE = (
    ("h100 pcie", "H100 PCIe", 756e12, 2.0e12),
    ("h100 80gb hbm3", "H100 SXM", 989e12, 3.35e12),
)

# the CPU (tests only): the SXM row, labelled as assumed
_CPU_PEAK = DevicePeak("H100 SXM (assumed: cpu)", 989e12, 3.35e12)


def peak_for_kind(kind: str) -> DevicePeak:
    """Spec-table lookup by device-name substring, no env overrides.
    Raises ``KeyError`` for a name the table does not hold."""
    k = (kind or "").lower()
    for sub, label, fl, bw in _PEAK_TABLE:
        if sub in k:
            return DevicePeak(label, fl, bw)
    raise KeyError(f"no peak for device {kind!r} in the table")


def peak_for_device(device: Any = None) -> DevicePeak:
    """Lookup for a torch device (``None``: the current card, else the
    CPU). The CPU gets the SXM row labelled as assumed; a CUDA card the
    table does not name raises ``KeyError``."""
    import torch

    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    dev = torch.device(device)
    if dev.type == "cpu":
        return _CPU_PEAK
    if dev.type != "cuda":
        raise ValueError(f"no peak for device type {dev.type!r}")
    return peak_for_kind(torch.cuda.get_device_name(dev))


def detect_peak(device: Any = None) -> DevicePeak:
    """The LIVE-telemetry peak of ``device`` (default: the current card,
    else the CPU) with env overrides ``EDL_PEAK_TFLOPS`` /
    ``EDL_PEAK_HBM_GBS`` applied on top — the escape hatch for cards the
    table predates. An unnamed card needs both overrides; without them
    this raises instead of guessing."""
    tf = os.environ.get("EDL_PEAK_TFLOPS")
    bw = os.environ.get("EDL_PEAK_HBM_GBS")
    try:
        peak = peak_for_device(device)
    except KeyError as e:
        if not (tf and bw):
            raise ValueError(
                f"{e.args[0]}: set EDL_PEAK_TFLOPS and EDL_PEAK_HBM_GBS "
                "to this card's dense bf16 peak and HBM bandwidth"
            ) from None
        import torch

        peak = DevicePeak(torch.cuda.get_device_name(device), 0.0, 0.0)
    if tf or bw:
        peak = DevicePeak(
            peak.kind + "+env",
            float(tf) * 1e12 if tf else peak.flops,
            float(bw) * 1e9 if bw else peak.hbm_bytes_s,
        )
    return peak


# ---------------------------------------------------------------------------
# FLOPs / params / bytes — transformer (llama + MoE via duck typing)


def _dims(cfg):
    hd = getattr(cfg, "head_dim", None)
    if hd is None:
        hd = cfg.d_model // cfg.n_heads
    return cfg.d_model, cfg.n_heads, cfg.n_kv_heads, hd, cfg.d_ff, \
        cfg.n_layers, cfg.vocab


def matmul_params(cfg) -> float:
    """Parameters participating in matmuls per token (embedding lookup
    excluded, lm_head included) — the ``N`` of the 6N/2N rules. MoE
    configs count the ACTIVATED expert width (top_k experts) plus the
    router — model FLOPs are per-token work actually done."""
    d, h, kv, hd, ff, L, V = _dims(cfg)
    ff_ways = getattr(cfg, "top_k", None) if hasattr(cfg, "n_experts") else None
    per_layer = (
        d * h * hd  # wq
        + 2 * d * kv * hd  # wk, wv
        + h * hd * d  # wo
        + 3 * d * ff * (ff_ways or 1)  # w1, w3, w2 (x active experts)
    )
    if hasattr(cfg, "n_experts"):
        per_layer += d * cfg.n_experts  # router projection
    return L * per_layer + d * V  # + lm_head


def n_params(cfg) -> float:
    """Total parameter count (for state sizing — MoE counts ALL
    experts here, unlike :func:`matmul_params`)."""
    d, h, kv, hd, ff, L, V = _dims(cfg)
    experts = getattr(cfg, "n_experts", 1) if hasattr(cfg, "n_experts") else 1
    per_layer = (
        2 * d  # ln1, ln2
        + d * h * hd + 2 * d * kv * hd + h * hd * d
        + 3 * d * ff * experts
    )
    if hasattr(cfg, "n_experts"):
        per_layer += d * cfg.n_experts
    return V * d + L * per_layer + d + d * V  # embed + layers + ln_f + lm_head


def attn_flops_per_token_train(cfg, seq: int) -> float:
    d, h, kv, hd, ff, L, V = _dims(cfg)
    return 12.0 * L * (seq / 2.0) * (h * hd)


def train_flops_per_token(cfg, seq: int) -> float:
    """Model FLOPs per trained token (fwd+bwd) — the MFU numerator
    ``models/llama.py:train_flops_per_token`` delegates to (5637.1
    MFLOPs on the flagship at T=2048)."""
    return 6.0 * matmul_params(cfg) + attn_flops_per_token_train(cfg, seq)


def fwd_flops_per_token(cfg, seq: int) -> float:
    """Forward-only model FLOPs per token at sequence length ``seq``
    (causal: average context seq/2) — the prefill numerator."""
    d, h, kv, hd, ff, L, V = _dims(cfg)
    return 2.0 * matmul_params(cfg) + 4.0 * L * (seq / 2.0) * (h * hd)


def prefill_flops(cfg, t: int) -> float:
    """One prompt prefill of ``t`` tokens (forward pass, cache build)."""
    return t * fwd_flops_per_token(cfg, t)


def decode_flops_per_token(cfg, s_ctx: int) -> float:
    """One cached decode step per row at (padded) context ``s_ctx``.
    The serving programs compute masked-dense attention over the FULL
    padded cache, so callers should pass the padded length — this is
    the cost of the program as compiled, not of the useful context."""
    d, h, kv, hd, ff, L, V = _dims(cfg)
    return 2.0 * matmul_params(cfg) + 4.0 * L * s_ctx * (h * hd)


def param_bytes(cfg, bytes_per_param: int = 2) -> float:
    """Weight bytes a decode step streams (bf16 export default)."""
    return n_params(cfg) * bytes_per_param


def kv_cache_bytes(
    cfg, slots: int, max_len: int, bytes_per_el: float = 2
) -> float:
    """The [L, slots, max_len, KV, hd] K + V cache pair.
    ``bytes_per_el`` may be fractional (packed int4 KV = 0.5)."""
    d, h, kv, hd, ff, L, V = _dims(cfg)
    return 2.0 * L * slots * max_len * kv * hd * bytes_per_el


def kv_pool_bytes(
    cfg, n_blocks: int, block_size: int, bytes_per_el: float = 2
) -> float:
    """The paged [L, n_blocks, block_size, KV, hd] K + V pool pair
    (includes the reserved scratch block — it occupies real HBM)."""
    d, h, kv, hd, ff, L, V = _dims(cfg)
    return 2.0 * L * n_blocks * block_size * kv * hd * bytes_per_el


def kv_quant_bytes_per_el(kv_quant: str) -> float:
    """KV pool bytes per logical element for a serving ``--kv-quant``
    mode: bf16 2, int8 1, packed int4 0.5."""
    return {"off": 2.0, "int8": 1.0, "int4": 0.5}[kv_quant]


def kv_scale_bytes(cfg, slots: int, s_pad: int, kv_block_size: int) -> float:
    """Bytes of the per-block-per-kv-head f32 scale planes a quantized
    decode step reads alongside the values: K + V planes, one f32 per
    (layer, block, kv head) over ``ceil(s_pad / block)`` blocks per
    slot. Zero when ``kv_block_size`` is 0 (unquantized — no scales)."""
    if kv_block_size <= 0:
        return 0.0
    d, h, kv, hd, ff, L, V = _dims(cfg)
    blocks = -(-s_pad // kv_block_size)
    return 2.0 * L * slots * blocks * kv * 4.0


def decode_step_bytes(
    cfg, param_bytes_total: float, b: int, s_pad: int,
    kv_bytes_per_el: float = 2, kv_block_size: int = 0,
) -> float:
    """HBM bytes one decode step must move: every parameter byte
    (weights stream once per token — the defining cost of small-batch
    decode) plus the FULL padded KV cache (the masked-dense decode
    attention reads all S slots every step, by construction).
    Activation traffic at B<=32 is noise next to these two. The exact
    formula ``bench.py`` publishes ``decode_pct_peak_bw`` with.

    Quantized paged KV narrows the cache term (``kv_bytes_per_el`` 1
    for int8, 0.5 for packed int4) and adds the per-block f32 scale
    strips the gather reads — pass the paged ``kv_block_size`` so the
    scale term is priced honestly (it is ~1/(2·bs) of the values for
    int8, small but not zero)."""
    return (
        param_bytes_total
        + kv_cache_bytes(cfg, b, s_pad, kv_bytes_per_el)
        + kv_scale_bytes(cfg, b, s_pad, kv_block_size)
    )


def train_step_bytes(cfg, tokens_per_step: int,
                     master_bytes_per_param: int = 4) -> float:
    """Crude lower bound on HBM traffic of one optimizer step: three
    passes over the f32 master weights (read for fwd/bwd, gradient
    write+read, updated write; factored adafactor moments are noise)
    plus the remat-era activation traffic (layer inputs saved+restored
    in bf16). Context for ``edl_bw_util_ratio{phase="train"}`` — train
    is compute-bound, so this ratio is informative, not a roofline."""
    d, h, kv, hd, ff, L, V = _dims(cfg)
    weights = 3.0 * n_params(cfg) * master_bytes_per_param
    acts = 2.0 * tokens_per_step * d * (L + 1) * 2  # save + restore, bf16
    return weights + acts


# ---------------------------------------------------------------------------
# CTR (the reference production workload)


def ctr_train_flops_per_example(
    emb: int = 16, mlp_dims=(400, 400, 400, 1), n_sparse: int = 26,
    n_dense: int = 13,
) -> float:
    """6 × matmul params of the Criteo-shaped CTR tower (models/ctr.py
    defaults). The embedding gather itself is bandwidth, not FLOPs."""
    in_dim = n_dense + n_sparse * emb
    total = 0.0
    for out_dim in mlp_dims:
        total += in_dim * out_dim
        in_dim = out_dim
    return 6.0 * total


# ---------------------------------------------------------------------------
# the per-phase cost bundle


@dataclass(frozen=True)
class Cost:
    """One operation's analytic bill: model FLOPs + HBM bytes moved."""

    flops: float
    hbm_bytes: float


class CostModel:
    """A config + device peak bound together: per-phase costs and the
    achieved/peak ratios. ``param_bytes_total`` should be the ACTUAL
    loaded tree's bytes when known (int8 records halve it — the ledger
    measures, the model predicts), else the bf16 estimate is used.
    ``kv_bytes_per_el``/``kv_block_size`` describe the KV pool the
    decode programs actually read: a quantized paged engine passes
    (1, block_size) for int8 KV or (0.5, block_size) for int4, which
    narrows the cache term and adds the f32 scale strips — keeping
    the live ``edl_bw_util_ratio{phase="decode"}`` truthful when the
    cache shrinks."""

    def __init__(
        self,
        cfg,
        peak: Optional[DevicePeak] = None,
        param_bytes_total: Optional[float] = None,
        kv_bytes_per_el: float = 2,
        kv_block_size: int = 0,
    ):
        self.cfg = cfg
        self.peak = peak or detect_peak()
        self.param_bytes = (
            float(param_bytes_total)
            if param_bytes_total is not None
            else param_bytes(cfg)
        )
        self.kv_bytes_per_el = kv_bytes_per_el
        self.kv_block_size = int(kv_block_size)

    def train_step(self, batch: int, seq: int) -> Cost:
        toks = batch * seq
        return Cost(
            flops=toks * train_flops_per_token(self.cfg, seq),
            hbm_bytes=train_step_bytes(self.cfg, toks),
        )

    def prefill(self, t: int) -> Cost:
        return Cost(
            flops=prefill_flops(self.cfg, t),
            # the prefill streams the weights once and writes t cache rows
            hbm_bytes=self.param_bytes
            + kv_cache_bytes(self.cfg, 1, t, self.kv_bytes_per_el),
        )

    def decode_block(self, b: int, horizon: int, s_pad: int) -> Cost:
        """One fused horizon block as dispatched: ``horizon`` steps of
        ``b`` rows (frozen rows still compute — program cost) at the
        full padded context."""
        step_bytes = decode_step_bytes(
            self.cfg, self.param_bytes, b, s_pad, self.kv_bytes_per_el,
            self.kv_block_size,
        )
        return Cost(
            flops=horizon * b * decode_flops_per_token(self.cfg, s_pad),
            hbm_bytes=horizon * step_bytes,
        )

    def verify_block(self, b: int, k: int, s_pad: int) -> Cost:
        """One speculative verify dispatch: ``k`` query lanes per row
        (pending token + k-1 drafts) in ONE weight pass. FLOPs scale
        with ``k`` like ``k`` decode steps, but HBM traffic is a
        SINGLE step's — the weights and the full padded cache stream
        once and feed every lane. That asymmetry is the whole point of
        speculation on a bandwidth-bound decode: accepted-tokens/
        dispatch > 1 multiplies tokens per byte moved."""
        step_bytes = decode_step_bytes(
            self.cfg, self.param_bytes, b, s_pad, self.kv_bytes_per_el,
            self.kv_block_size,
        )
        return Cost(
            flops=k * b * decode_flops_per_token(self.cfg, s_pad),
            hbm_bytes=step_bytes,
        )

    def mfu(self, flops_per_s: float) -> float:
        return flops_per_s / self.peak.flops if self.peak.flops > 0 else 0.0

    def bw_util(self, bytes_per_s: float) -> float:
        return (
            bytes_per_s / self.peak.hbm_bytes_s
            if self.peak.hbm_bytes_s > 0
            else 0.0
        )


# ---------------------------------------------------------------------------
# live gauges


class EfficiencyMeter:
    """Accumulates analytic (flops, bytes, busy-seconds) per phase and
    publishes the live roofline gauges:

    * ``edl_mfu{phase}``           — analytic FLOPs/s over peak FLOPs
    * ``edl_bw_util_ratio{phase}`` — analytic bytes/s over peak HBM BW
    * ``edl_costmodel_flops_total{phase}`` /
      ``edl_costmodel_hbm_bytes_total{phase}`` — the raw integrals,
      for ``rate()``-style windowed queries a cumulative gauge can't
      answer.

    Callers pass NON-OVERLAPPING busy seconds (the serving engine
    clips block wall times against the previous drain so the double
    buffer cannot double-count time). Cumulative by design: the gauges
    answer "how efficient has this process been", the counters let a
    scraper window it. Hot-path cost per observe: one lock + a few
    dict hits (well under the 1% instrumentation budget)."""

    def __init__(
        self,
        peak: Optional[DevicePeak] = None,
        registry: Optional[obs_metrics.MetricsRegistry] = None,
    ):
        self.peak = peak or detect_peak()
        r = registry or obs_metrics.default_registry()
        self._lock = threading.Lock()
        self._acc: Dict[str, list] = {}  # phase -> [flops, bytes, seconds]
        self._g_mfu = r.gauge(
            "edl_mfu",
            "achieved model FLOPs/s over peak FLOPs by phase (obs/costmodel.py)",
            ("phase",),
        )
        self._g_bw = r.gauge(
            "edl_bw_util_ratio",
            "achieved HBM bytes/s over peak bandwidth by phase",
            ("phase",),
        )
        self._c_flops = r.counter(
            "edl_costmodel_flops_total",
            "analytic model FLOPs completed by phase",
            ("phase",),
        )
        self._c_bytes = r.counter(
            "edl_costmodel_hbm_bytes_total",
            "analytic HBM bytes moved by phase",
            ("phase",),
        )

    def observe(self, phase: str, cost: Cost, seconds: float) -> None:
        """Account one operation's cost against ``seconds`` of busy
        wall time and refresh the phase's gauges."""
        if seconds <= 0:
            return
        with self._lock:
            acc = self._acc.setdefault(phase, [0.0, 0.0, 0.0])
            acc[0] += cost.flops
            acc[1] += cost.hbm_bytes
            acc[2] += seconds
            fl, by, s = acc
        self._c_flops.inc(cost.flops, phase=phase)
        self._c_bytes.inc(cost.hbm_bytes, phase=phase)
        self._g_mfu.set(
            fl / s / self.peak.flops if self.peak.flops else 0.0, phase=phase
        )
        self._g_bw.set(
            by / s / self.peak.hbm_bytes_s if self.peak.hbm_bytes_s else 0.0,
            phase=phase,
        )

    def set_rates(
        self, phase: str, flops_per_s: float, bytes_per_s: float
    ) -> None:
        """Direct gauge refresh from already-averaged rates (the
        trainer publishes examples/s × flops/example this way)."""
        self._g_mfu.set(
            flops_per_s / self.peak.flops if self.peak.flops else 0.0,
            phase=phase,
        )
        self._g_bw.set(
            bytes_per_s / self.peak.hbm_bytes_s
            if self.peak.hbm_bytes_s
            else 0.0,
            phase=phase,
        )


def efficiency_snapshot(
    registry: Optional[obs_metrics.MetricsRegistry] = None,
) -> Dict[str, float]:
    """Flat dict view of the live efficiency/memory gauges — what the
    monitor's EFFICIENCY strip (``edl monitor --json``) carries. Keys:
    ``mfu_<phase>``, ``bw_util_<phase>``, ``hbm_bytes_<category>``,
    ``kv_occupancy_ratio``. Empty when nothing has published yet."""
    r = registry or obs_metrics.default_registry()
    out: Dict[str, float] = {}
    for metric, prefix in (("edl_mfu", "mfu"), ("edl_bw_util_ratio", "bw_util")):
        fam = r.get(metric)
        if fam is None:
            continue
        for key, s in fam.samples():
            if key and s[0]:
                out[f"{prefix}_{key[0]}"] = s[0]
    fam = r.get("edl_hbm_bytes")
    if fam is not None:
        for key, s in fam.samples():
            if key and s[0]:
                out[f"hbm_bytes_{key[0]}"] = s[0]
    fam = r.get("edl_kv_occupancy_ratio")
    if fam is not None:
        v = fam.value()
        if v:
            out["kv_occupancy_ratio"] = v
    return out
