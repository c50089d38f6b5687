"""Continuous-batching generation engine — the port of
``edl_tpu/serving/engine.py``: the contiguous KV cache, the paged KV
cache (prefix cache, chunked prefill, preemption to fit the pool),
quantized paged KV (int8 / int4) and speculative decoding.

A fixed table of ``max_slots`` KV slots decodes every active request in
one batched step; new requests prefill into free slots and finished
ones leave BETWEEN blocks. Decode runs in fused HORIZON blocks
(``llama.decode_horizon_slots[_paged]``: H steps per dispatch, per-slot
EOS / budget termination on the device), and the host pipeline is
double buffered: block k+1 is queued before block k's token matrix is
read.

How the reference's JAX mechanics map onto PyTorch:

* **Donation becomes in-place.** The reference donates ``kc``/``vc``
  (and the quantized pool's scale planes) to XLA and asserts the old
  buffers died. Here the KV cache or block pool is allocated once and
  written in place by every prefill, decode step, verify step and
  copy-on-write block copy; there is nothing to assert.
* **The double buffer.** A plain ``.cpu()`` of block k's tokens, made
  after block k+1 was queued, would wait for k+1 too. So at dispatch
  the engine queues a ``non_blocking`` copy of the token matrix into
  pinned host memory and records a ``torch.cuda.Event``; the drain
  waits on that event only. Host arrays bound for the card (block
  tables, draft matrices, prompt chunks) go through pinned memory too:
  a pageable copy would stall the host behind every queued kernel.
* **Programs need no memo.** PyTorch runs eagerly; block tables, chunk
  starts and lengths are plain arguments. The prefill still pads
  prompts into power-of-two buckets (``_bucket``), which keeps the
  contiguous path's attention on the flash kernel's supported lengths
  exactly as the reference does. The paged path never calls the flash
  kernel: its prefill and decode attend through the block table with a
  masked dense einsum, as the reference's do.

Greedy decode is token-identical to sequential ``llama.generate`` at
every horizon, with mid-stream joins, EOS inside a block, deadline
evictions, prefix-cache hits, chunked prefill, preemption and
speculation (quantized KV is held to an agreement tolerance instead).
Any exception escaping a step triggers :meth:`_recover`: the device
state is rebuilt and every live slot re-prefilled from
``prompt + generated`` (greedy replay is token-identical), with the
per-request ``max_recoveries`` bound. Temperature sampling draws from
the engine's own seeded ``torch.Generator``.

Params are a dense tree or the weight-only int8 tree of
``llama.quantize_params_int8`` (``serve --int8``); every path takes
either, since the model's products dispatch on the record.

Not ported yet: the reference's observability hooks (compile watch,
cost model, memory ledger, flight recorder, tracing, fault points).
"""

from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Deque, Dict, List, Optional

import numpy as np
import torch

from edl_tpu_torch.models import llama
from edl_tpu_torch.serving import paged as _paged
from edl_tpu_torch.serving import spec as _spec
from edl_tpu_torch.serving.metrics import ServingMetrics
from edl_tpu_torch.serving.scheduler import (
    AdmissionError,
    InterleavePolicy,
    Request,
    RequestQueue,
)
from edl_tpu_torch.utils.device import DeviceLike, resolve_device, tree_device
from edl_tpu_torch.utils.logging import kv_logger

log = kv_logger("serving")


class SpecAcceptGuard:
    """Live quality gate for the quantized-KV path: speculative
    acceptance is a free probe of output quality (the verifier's argmax
    IS the model's output, so if quantization bends the distribution,
    drafts stop matching). The guard warms a baseline up from the first
    ``warmup`` verify blocks, then freezes it and flags DEGRADED when
    the acceptance EMA drops more than ``tol`` (absolute rate points)
    below it. Publishes ``edl_kv_quant_quality_ok`` (1 healthy / 0
    degraded) and logs each transition — an operator alarm, not a
    fallback."""

    def __init__(self, registry, *, warmup: int = 20, tol: float = 0.05,
                 alpha: float = 0.1):
        self.warmup = int(warmup)
        self.tol = float(tol)
        self.alpha = float(alpha)
        self.baseline: Optional[float] = None
        self.ema: Optional[float] = None
        self.ok = True
        self._seen = 0
        self._acc_sum = 0.0
        self._g_ok = registry.gauge(
            "edl_kv_quant_quality_ok",
            "1 while the quantized-KV spec-acceptance EMA holds its "
            "warmed-up baseline, 0 after a degradation (serving/engine"
            ".py SpecAcceptGuard)",
        )
        self._g_ok.set(1.0)

    def observe(self, drafted: int, accepted: int) -> None:
        """Feed one verify block's (drafted, accepted) counts."""
        if drafted <= 0:
            return
        rate = accepted / drafted
        self.ema = (
            rate if self.ema is None
            else (1 - self.alpha) * self.ema + self.alpha * rate
        )
        if self.baseline is None:
            self._seen += 1
            self._acc_sum += rate
            if self._seen >= self.warmup:
                self.baseline = self._acc_sum / self._seen
            return
        degraded = self.ema < self.baseline - self.tol
        if degraded == self.ok:  # transition either way
            self.ok = not degraded
            self._g_ok.set(1.0 if self.ok else 0.0)
            (log.warn if degraded else log.info)(
                "kv_quant quality", ok=self.ok, ema=round(self.ema, 4),
                baseline=round(self.baseline, 4), tol=self.tol,
            )


@dataclass
class _Slot:
    """Host-side state of one occupied KV slot. ``prompt`` +
    ``generated`` (drained tokens only) is the recovery truth."""

    rid: str
    prompt: List[int]
    max_new: int
    eos_id: Optional[int]
    generated: List[int] = field(default_factory=list)
    deadline: Optional[float] = None
    recoveries: int = 0
    tenant: Optional[str] = None
    slo_class: Optional[str] = None
    # chunked prefill (paged mode): next prompt index still to prefill;
    # None once the final piece ran and the slot is decoding
    pf_next: Optional[int] = None
    # admission sequence number: preemption evicts the YOUNGEST slot
    born: int = 0


@dataclass
class RequestResult:
    rid: str
    tokens: List[int]
    outcome: str  # done | eos | timeout | failed


@dataclass
class _Block:
    """One dispatched, not yet drained horizon or verify block."""

    host: torch.Tensor  # [B, H] token matrix (pinned host copy on CUDA)
    ready: Optional[torch.cuda.Event]  # None on the CPU
    t_dispatch: float
    members: Dict[int, str]  # lane -> rid of its occupant at dispatch
    drafted: Optional[Dict[int, int]] = None  # verify: lane -> drafts


class ContinuousBatchingEngine:
    """In-process continuous-batching server over a llama param tree
    (dense in ``cfg.dtype``, or with int8 weight records, on
    ``device``). The KV cache is either
    [L, max_slots, KV, max_len, hd] (contiguous) or, with
    ``block_size > 0``, a pool [L, pool_blocks, KV, block_size, hd]
    (both head-major, see ``models/llama.py``) addressed through per-slot block tables (int8 with hd packed, plus
    f32 scales [L, pool_blocks, KV], under ``kv_quant``); allocated
    once and updated in place.

    Drive it with :meth:`submit` + :meth:`step` or :meth:`run`;
    completed requests land in ``results``."""

    def __init__(
        self,
        params: Any,
        cfg: llama.LlamaConfig,
        *,
        max_slots: int = 8,
        max_len: int = 256,
        horizon: int = 1,
        queue: Optional[RequestQueue] = None,
        metrics: Optional[ServingMetrics] = None,
        policy: Optional[InterleavePolicy] = None,
        temperature: float = 0.0,
        seed: int = 0,
        min_bucket: int = 8,
        max_recoveries: int = 2,
        block_size: int = 0,
        pool_blocks: Optional[int] = None,
        prefix_cache: bool = False,
        prefill_chunk: int = 0,
        kv_quant: str = "off",
        spec_k: int = 0,
        spec_ngram: int = 3,
        spec_min_accept: float = 0.0,
        device: DeviceLike = None,
        clock=time.monotonic,
    ):
        if max_slots < 1:
            raise ValueError(f"max_slots must be >= 1, got {max_slots}")
        if horizon < 1:
            raise ValueError(f"horizon must be >= 1, got {horizon}")
        if temperature < 0:
            raise ValueError(f"temperature must be >= 0, got {temperature}")
        if max_recoveries < 0:
            raise ValueError(
                f"max_recoveries must be >= 0, got {max_recoveries}"
            )
        if spec_k < 0:
            raise ValueError(f"spec_k must be >= 0, got {spec_k}")
        if spec_k > 0:
            # speculation is greedy-only: acceptance compares drafts to
            # argmax, and a sampled stream has no "the" next token
            if temperature > 0:
                raise ValueError(
                    "spec_k > 0 requires greedy decoding "
                    f"(temperature 0), got temperature {temperature}"
                )
            if spec_ngram < 1:
                raise ValueError(
                    f"spec_ngram must be >= 1, got {spec_ngram}"
                )
        # paged KV mode: memory scales with RESIDENT tokens, and
        # admission gates on free blocks instead of free slots
        self._paged = block_size > 0
        if self._paged:
            if max_len % block_size != 0:
                raise ValueError(
                    f"max_len {max_len} must be a multiple of "
                    f"block_size {block_size}"
                )
            self._m = max_len // block_size  # table width (blocks/slot)
            if pool_blocks is None:
                # the contiguous engine's capacity + scratch
                pool_blocks = max_slots * self._m + 1
            if pool_blocks < self._m + 1:
                # the usable pool must hold ONE full-length sequence, the
                # invariant that makes preemption-to-fit always succeed
                raise ValueError(
                    f"pool_blocks {pool_blocks} < {self._m + 1} "
                    f"(scratch + one full sequence of {self._m} blocks)"
                )
            if prefill_chunk < 0:
                raise ValueError(
                    f"prefill_chunk must be >= 0, got {prefill_chunk}"
                )
        elif prefix_cache or prefill_chunk:
            raise ValueError(
                "prefix_cache/prefill_chunk require block_size > 0"
            )
        else:
            self._m = 0
        if kv_quant not in ("off", "int8", "int4"):
            raise ValueError(
                f"kv_quant must be one of off/int8/int4, got {kv_quant!r}"
            )
        if kv_quant != "off":
            if not self._paged:
                raise ValueError(
                    "kv_quant requires the paged KV cache (block_size > 0)"
                )
            # raises for int4 on odd head_dim (two lanes pack per byte)
            llama.kvq_packed_head_dim(kv_quant, cfg.head_dim)
        self.kv_quant = str(kv_quant)
        self.block_size = int(block_size)
        self.pool_blocks = int(pool_blocks) if self._paged else 0
        self.prefill_chunk = int(prefill_chunk)
        self._use_prefix = bool(prefix_cache)
        self._admit_seq = 0
        self.device = resolve_device(device)
        pdev = tree_device(params)
        if pdev is not None and pdev.type != self.device.type:
            raise ValueError(
                f"params live on {pdev} but the engine runs on {self.device}"
            )
        self.params = params
        self.cfg = cfg
        self.max_slots = max_slots
        self.max_len = max_len
        self.horizon = horizon
        self.queue = queue or RequestQueue(max_total_len=max_len, clock=clock)
        if self.queue.max_total_len > max_len:
            raise ValueError(
                f"queue admits up to {self.queue.max_total_len} total "
                f"tokens but KV slots hold {max_len}"
            )
        self.metrics = metrics or ServingMetrics(clock=clock)
        self.policy = policy or InterleavePolicy()
        self.temperature = float(temperature)
        self.min_bucket = min_bucket
        self.max_recoveries = max_recoveries
        self.recoveries = 0  # engine-total recovery passes
        self.clock = clock
        self.results: Dict[str, RequestResult] = {}
        self._sampling = self.temperature > 0
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(seed)
        # speculative draft-verify: each verify dispatch scores spec_k
        # host-drafted tokens + the pending token in one weight pass
        self.spec_k = int(spec_k)
        self.spec_ngram = int(spec_ngram)
        self.spec_min_accept = float(spec_min_accept)
        self._spec_policy = (
            _spec.SpecPolicy(min_accept=self.spec_min_accept)
            if self.spec_k > 0 else None
        )
        # the quantized path's live quality gate: speculation provides
        # the acceptance probe
        self._kvq_guard = (
            SpecAcceptGuard(self.metrics.registry)
            if self.kv_quant != "off" and self.spec_k > 0 else None
        )
        self._slots: List[Optional[_Slot]] = [None] * max_slots
        # popped from the queue but not yet slotted — requeued at the
        # head if the admission prefill raises
        self._admitting: Optional[Request] = None
        self._draining = False
        self._kc: Optional[torch.Tensor] = None
        self._vc: Optional[torch.Tensor] = None
        self._ks: Optional[torch.Tensor] = None
        self._vs: Optional[torch.Tensor] = None
        self._alloc_device_state()
        log.info(
            "engine ready", slots=max_slots, max_len=max_len,
            horizon=horizon, device=str(self.device),
            cache_mb=round(self.kv_nbytes / 2**20, 1),
            paged=self._paged, block_size=self.block_size,
            pool_blocks=self.pool_blocks, kv_quant=self.kv_quant,
            spec_k=self.spec_k, sampling=self._sampling,
        )

    @property
    def kv_nbytes(self) -> int:
        """Bytes of the KV cache or pool, scale planes included."""
        planes = [self._kc, self._vc, self._ks, self._vs]
        return sum(p.nbytes for p in planes if p is not None)

    def _alloc_device_state(self) -> None:
        """(Re)allocate the slot decode state, the KV cache or pool (and
        the paged host bookkeeping) and the in-flight queue — at
        construction and in :meth:`_recover`."""
        cfg, n, dev = self.cfg, self.max_slots, self.device
        self._dtok = torch.zeros(n, dtype=torch.long, device=dev)
        self._dpos = torch.zeros(n, dtype=torch.long, device=dev)
        self._dact = torch.zeros(n, dtype=torch.bool, device=dev)
        self._drem = torch.zeros(n, dtype=torch.long, device=dev)
        self._deos = torch.full((n,), -1, dtype=torch.long, device=dev)
        L, kvh, hd = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim
        # free the old cache before the new one
        self._kc = self._vc = self._ks = self._vs = None
        if self._paged:
            # a block POOL; block 0 is SCRATCH (pads and frozen lanes
            # write there, nothing reads it). The allocator, tables and
            # prefix cache are HOST truth rebuilt here from nothing:
            # after a recovery the pool is zeros, so every earlier block
            # (cached prefixes included) is gone, and the replay
            # re-prefills what it needs.
            if self.kv_quant != "off":
                # int8 entries (int4 packs two per byte along hd) and
                # per-block-per-kv-head f32 scales; a zero scale decodes
                # a zero block, so the fresh pool is self-consistent
                hdp = llama.kvq_packed_head_dim(self.kv_quant, hd)
                shape = (L, self.pool_blocks, kvh, self.block_size, hdp)
                self._kc = torch.zeros(shape, dtype=torch.int8, device=dev)
                self._vc = torch.zeros(shape, dtype=torch.int8, device=dev)
                sshape = (L, self.pool_blocks, kvh)
                self._ks = torch.zeros(sshape, dtype=torch.float32,
                                       device=dev)
                self._vs = torch.zeros(sshape, dtype=torch.float32,
                                       device=dev)
            else:
                shape = (L, self.pool_blocks, kvh, self.block_size, hd)
                self._kc = torch.zeros(shape, dtype=cfg.dtype, device=dev)
                self._vc = torch.zeros(shape, dtype=cfg.dtype, device=dev)
            self._balloc = _paged.BlockAllocator(
                self.pool_blocks, self.block_size
            )
            self._prefix = (
                _paged.PrefixCache(self._balloc) if self._use_prefix
                else None
            )
            self._tables: List[List[int]] = [
                [_paged.SCRATCH] * self._m for _ in range(n)
            ]
        else:
            shape = (L, n, kvh, self.max_len, hd)  # head-major
            self._kc = torch.zeros(shape, dtype=cfg.dtype, device=dev)
            self._vc = torch.zeros(shape, dtype=cfg.dtype, device=dev)
        # lanes deadline-evicted (or preempted) while their device row
        # still decoded: blocks dispatched before carry the old request's
        # tokens there, so the lane is reused only after they drain
        self._stale: set = set()
        self._inflight: Deque[_Block] = deque()

    # -- request intake -----------------------------------------------------

    def submit(
        self,
        rid: str,
        prompt: List[int],
        max_new: int,
        eos_id: Optional[int] = None,
        deadline_s: Optional[float] = None,
        *,
        tenant: Optional[str] = None,
        slo_class: Optional[str] = None,
    ) -> None:
        """Queue a request; raises :class:`AdmissionError` (and counts
        the rejection) when admission control refuses it."""
        self.metrics.on_submit(rid, tenant=tenant, slo_class=slo_class)
        if rid in self.results or any(
            s is not None and s.rid == rid for s in self._slots
        ):
            self._reject(rid, "bad_request", f"duplicate request id {rid!r}")
        bad = [t for t in prompt if not 0 <= int(t) < self.cfg.vocab]
        if bad:
            self._reject(
                rid, "bad_request",
                f"{rid}: prompt tokens {bad[:4]} outside [0, {self.cfg.vocab})",
            )
        if deadline_s is not None and deadline_s <= 0:
            self._reject(
                rid, "bad_request",
                f"{rid}: deadline_s must be > 0, got {deadline_s}",
            )
        try:
            self.queue.submit(
                Request(rid=rid, prompt=list(map(int, prompt)),
                        max_new=int(max_new), eos_id=eos_id,
                        deadline_s=deadline_s, tenant=tenant,
                        slo_class=slo_class)
            )
        except AdmissionError as e:
            self.metrics.on_reject(rid, e.reason)
            raise

    def _reject(self, rid: str, reason: str, msg: str) -> None:
        self.metrics.on_reject(rid, reason)
        raise AdmissionError(reason, msg)

    # -- the engine loop ----------------------------------------------------

    @property
    def active_slots(self) -> int:
        return sum(1 for s in self._slots if s is not None)

    @property
    def has_work(self) -> bool:
        return (
            self.active_slots > 0
            or (self.queue.depth > 0 and not self._draining)
            or bool(self._inflight)
        )

    @property
    def draining(self) -> bool:
        return self._draining

    def step(self) -> int:
        """One iteration: admit up to the block budget, advance chunked
        prefills by one chunk each, dispatch ONE horizon (or verify)
        block over every decoding slot, drain the PREVIOUS block while
        the new one runs. Returns tokens observed this iteration. An
        exception escaping the iteration triggers :meth:`_recover`
        instead of propagating."""
        try:
            return self._step_inner()
        except Exception as e:  # the engine must keep serving
            self._recover(e)
            return 0

    def _step_inner(self) -> int:
        emitted = 0
        self._evict_overdue()
        if self.queue.depth > 0 and not self._draining:
            if self._inflight and not any(s is None for s in self._slots):
                # drain-to-admit: an in-flight block may have freed a slot
                emitted += self._drain_all()
            emitted += self._admit()
        if self._paged:
            # one bounded prefill chunk per prefilling slot per step,
            # interleaved with the decode block below
            emitted += self._advance_prefills()
        self.metrics.on_step(self.active_slots, self.max_slots,
                             self.queue.depth)
        # slots still mid-chunked-prefill have no decode state yet
        decoding = sum(
            1 for s in self._slots if s is not None and s.pf_next is None
        )
        if decoding:
            if self.spec_k > 0:
                emitted += self._step_spec()
            else:
                self._dispatch_block()
                while len(self._inflight) > 1:
                    emitted += self._drain_one()
        else:
            emitted += self._drain_all()
        return emitted

    def _step_spec(self) -> int:
        """One speculative iteration: draft per decoding slot from its
        committed ``prompt + generated``, dispatch ONE verify step over
        every slot (undrafted slots ride along as -1 sentinels = one
        plain decode step) and drain synchronously — the drafter needs
        block k's tokens to draft block k+1. When NO slot drafts, a
        plain horizon block runs instead."""
        emitted = self._drain_all()
        drafts: Dict[int, List[int]] = {}
        for i, sl in enumerate(self._slots):
            if sl is None or sl.pf_next is not None:
                continue
            if not self._spec_policy.should_draft(sl.rid):
                continue
            row = _spec.draft_ngram(
                sl.prompt + sl.generated, self.spec_ngram, self.spec_k
            )
            if row:
                drafts[i] = row
        if drafts:
            self._dispatch_verify(drafts)
        else:
            self._dispatch_block()
        emitted += self._drain_all()
        return emitted

    def run(self, max_steps: Optional[int] = None) -> Dict[str, RequestResult]:
        """Drain queue + slots (or stop after ``max_steps``)."""
        steps = 0
        while self.has_work and (max_steps is None or steps < max_steps):
            self.step()
            steps += 1
        if self._inflight:
            try:
                self._drain_all()
            except Exception as e:  # same boundary as step()
                self._recover(e)
        return dict(self.results)

    # -- graceful drain (half-close) ----------------------------------------

    def half_close(self) -> None:
        """Stop admitting queued requests; in-flight slots finish."""
        self._draining = True

    def reopen(self) -> None:
        self._draining = False

    def take_residual(self) -> List[Request]:
        """Pop every still-queued request, in FIFO order."""
        residual: List[Request] = []
        while True:
            req = self.queue.pop()
            if req is None:
                return residual
            residual.append(req)

    def drain(self, max_steps: Optional[int] = None) -> List[Request]:
        """Half-close, run in-flight slots to completion, return the
        residual queued requests intact."""
        self.half_close()
        steps = 0
        while (self.active_slots > 0 or self._inflight) and (
            max_steps is None or steps < max_steps
        ):
            self.step()
            steps += 1
        if self._inflight:
            try:
                self._drain_all()
            except Exception as e:  # same boundary as step()
                self._recover(e)
        return self.take_residual()

    # -- internals ----------------------------------------------------------

    def _to_host(self, toks: torch.Tensor):
        """Queue the token matrix's copy to the host without waiting:
        pinned memory + an event on CUDA, the tensor itself on the CPU."""
        if toks.device.type != "cuda":
            return toks, None
        host = torch.empty(toks.shape, dtype=toks.dtype, pin_memory=True)
        host.copy_(toks, non_blocking=True)
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(toks.device))
        return host, ev

    def _upload(self, arr: np.ndarray) -> torch.Tensor:
        """A host int array on the engine's device. On CUDA through
        pinned memory with a non-blocking copy: a pageable copy waits
        for every queued kernel. (The caching host allocator keeps the
        pinned buffer alive until the copy has run.)"""
        t = torch.from_numpy(np.ascontiguousarray(arr, dtype=np.int64))
        if self.device.type != "cuda":
            return t
        return t.pin_memory().to(self.device, non_blocking=True)

    def _kv_kwargs(self) -> Dict[str, Any]:
        return {"kv_quant": self.kv_quant, "ks": self._ks, "vs": self._vs}

    def _dispatch_table(self) -> torch.Tensor:
        """The [B, M] block table snapshot of one decode or verify
        dispatch. Coverage grows BEFORE the snapshot: the block may move
        each decoding slot past a block boundary, and growing may
        preempt other slots, whose rows then stay all-scratch."""
        for i, sl in enumerate(self._slots):
            if sl is not None and sl.pf_next is None:
                self._ensure_cover(i)
        tbl = np.zeros((self.max_slots, self._m), np.int64)
        for i, sl in enumerate(self._slots):
            if sl is not None and sl.pf_next is None:
                tbl[i] = self._tables[i]
        return self._upload(tbl)

    def _push_block(self, toks: torch.Tensor,
                    drafted: Optional[Dict[int, int]] = None) -> None:
        host, ev = self._to_host(toks)
        # lane i's tokens belong to slot i's occupant AT DISPATCH; a
        # lane mid-chunked-prefill is not a member
        members = {
            i: s.rid for i, s in enumerate(self._slots)
            if s is not None and s.pf_next is None
        }
        self._inflight.append(
            _Block(host, ev, self.clock(), members, drafted))

    def _dispatch_block(self) -> None:
        if self._paged:
            table = self._dispatch_table()
            (toks, self._dtok, self._dpos, self._dact,
             self._drem) = llama.decode_horizon_slots_paged(
                self.params, self._dtok, self._dpos, self._dact,
                self._drem, self._deos, table, self._kc, self._vc,
                self.cfg, block_size=self.block_size, horizon=self.horizon,
                generator=self._gen,
                temperature=self.temperature if self._sampling else 1.0,
                sampling=self._sampling, **self._kv_kwargs(),
            )[:5]
        else:
            (toks, self._dtok, self._dpos, self._dact, self._drem,
             self._kc, self._vc) = llama.decode_horizon_slots(
                self.params, self._dtok, self._dpos, self._dact, self._drem,
                self._deos, self._kc, self._vc, self.cfg,
                horizon=self.horizon, generator=self._gen,
                temperature=self.temperature if self._sampling else 1.0,
                sampling=self._sampling,
            )
        self.metrics.on_dispatch("decode")
        self._push_block(toks)

    def _dispatch_verify(self, drafts: Dict[int, List[int]]) -> None:
        """One speculative verify dispatch over every slot: the [B, D]
        draft matrix holds -1 sentinels for undrafted or absent slots (a
        sentinel row is exactly one plain decode step)."""
        d = self.spec_k
        dm = np.full((self.max_slots, d), -1, np.int64)
        drafted: Dict[int, int] = {}
        for i, row in drafts.items():
            row = row[:d]
            dm[i, :len(row)] = row
            drafted[i] = len(row)
        if self._paged:
            # _ensure_cover maps max(horizon, K) positions ahead, so
            # every position an accepted run can commit is private
            table = self._dispatch_table()
            (toks, self._dtok, self._dpos, self._dact,
             self._drem) = llama.verify_step_slots_paged(
                self.params, self._dtok, self._upload(dm), self._dpos,
                self._dact, self._drem, self._deos, table, self._kc,
                self._vc, self.cfg, block_size=self.block_size,
                **self._kv_kwargs(),
            )[:5]
        else:
            (toks, self._dtok, self._dpos, self._dact,
             self._drem) = llama.verify_step_slots(
                self.params, self._dtok, self._upload(dm), self._dpos,
                self._dact, self._drem, self._deos, self._kc, self._vc,
                self.cfg,
            )[:5]
        self.metrics.on_dispatch("verify")
        self._push_block(toks, drafted)

    def _drain_one(self) -> int:
        """Read the OLDEST in-flight block's [B, H] token matrix and
        replay it into the host bookkeeping. Frozen lanes read -1."""
        blk = self._inflight.popleft()
        if blk.ready is not None:
            blk.ready.synchronize()
        out = blk.host.numpy()
        self.metrics.on_block(self.clock() - blk.t_dispatch)
        emitted = 0
        spec_drafted = spec_accepted = 0
        for i in range(self.max_slots):
            sl = self._slots[i]
            if sl is None or blk.members.get(i) != sl.rid:
                continue  # freed, or the lane held another request
            n = 0
            outcome = None
            for t in out[i]:
                t = int(t)
                if t < 0:
                    break
                sl.generated.append(t)
                n += 1
                if sl.eos_id is not None and t == sl.eos_id:
                    outcome = "eos"
                    break
                if len(sl.generated) >= sl.max_new:
                    outcome = "done"
                    break
            if n:
                self.metrics.on_tokens(sl.rid, n)
                emitted += n
            if blk.drafted is not None and blk.drafted.get(i, 0) > 0:
                # of this row's emitted run, all but the bonus token were
                # accepted drafts
                nd = blk.drafted[i]
                acc = max(0, n - 1)
                spec_drafted += nd
                spec_accepted += acc
                self._spec_policy.observe(sl.rid, nd, acc)
            if outcome:
                self._finish(i, outcome)
        if blk.drafted is not None:
            self.metrics.on_spec(spec_drafted, spec_accepted)
            if self._kvq_guard is not None:
                self._kvq_guard.observe(spec_drafted, spec_accepted)
        return emitted

    def _drain_all(self) -> int:
        emitted = 0
        while self._inflight:
            emitted += self._drain_one()
        return emitted

    def _bucket(self, n: int) -> int:
        b = self.min_bucket
        while b < n:
            b *= 2
        return min(b, self.max_len)

    def _evict_overdue(self) -> None:
        """A live slot past its deadline finishes now (outcome
        "timeout"); its lane is marked stale (see ``_stale``)."""
        now = self.clock()
        for i, sl in enumerate(self._slots):
            if sl is not None and sl.deadline is not None and now > sl.deadline:
                self._finish(i, "timeout")
                self._stale.add(i)

    def _shed_expired(self, req: Request) -> bool:
        """A popped request whose deadline passed while queued is shed
        as ``rejected:timeout``, counted once, never admitted."""
        dl = req.deadline_at()
        if dl is None or self.clock() <= dl:
            return False
        self.metrics.on_reject(req.rid, "timeout")
        self.results[req.rid] = RequestResult(
            rid=req.rid, tokens=[], outcome="timeout"
        )
        return True

    def _admit(self) -> int:
        free = [i for i, s in enumerate(self._slots) if s is None]
        budget = self.policy.block_budget(
            len(free), self.queue.depth, self.horizon
        )
        emitted = 0
        for _ in range(budget):
            req = self.queue.pop()
            if req is None:
                break
            if self._shed_expired(req):
                continue
            if self._paged and not self._pg_admittable(req):
                # admission gates on BLOCKS: the head of the line keeps
                # its place and retries at the next boundary
                self.queue.requeue_front(req)
                break
            self.metrics.on_pop(req.rid)
            slot = free.pop(0)
            self._admitting = req
            if slot in self._stale and self._inflight:
                emitted += self._drain_all()
            self._stale.discard(slot)
            if self._paged:
                start = self._pg_setup_table(slot, req.prompt)
                if self.prefill_chunk and (
                    len(req.prompt) - start > self.prefill_chunk
                ):
                    # long prompt: admit now with its blocks reserved and
                    # prefill in bounded chunks between decode blocks
                    self._slots[slot] = _Slot(
                        rid=req.rid, prompt=list(req.prompt),
                        max_new=req.max_new, eos_id=req.eos_id,
                        deadline=req.deadline_at(),
                        tenant=req.tenant, slo_class=req.slo_class,
                        pf_next=start, born=self._admit_seq,
                    )
                    self._admit_seq += 1
                    self._admitting = None
                    self.metrics.on_admit(req.rid, len(req.prompt))
                    continue
                tok0 = self._pg_prefill(slot, req.prompt, start,
                                        req.max_new, req.eos_id)
                self._pg_cache_insert(slot, req.prompt)
            else:
                tok0 = self._prefill_into(slot, req.prompt, req.max_new,
                                          req.eos_id)
            self.metrics.on_admit(req.rid, len(req.prompt))
            sl = _Slot(
                rid=req.rid, prompt=list(req.prompt), max_new=req.max_new,
                eos_id=req.eos_id, generated=[tok0],
                deadline=req.deadline_at(),
                tenant=req.tenant, slo_class=req.slo_class,
                born=self._admit_seq,
            )
            self._admit_seq += 1
            self._slots[slot] = sl
            self._admitting = None
            self.metrics.on_token(req.rid)
            emitted += 1
            if sl.eos_id is not None and tok0 == sl.eos_id:
                self._finish(slot, "eos")
            elif sl.max_new <= 1:
                self._finish(slot, "done")
        return emitted

    def _prefill_into(
        self, slot: int, seq: List[int], max_new: int,
        eos_id: Optional[int], replay: bool = False,
    ) -> int:
        """Prefill ``seq`` into slot ``slot`` and return the first token
        (a host sync by design: the first token IS the TTFT sample).
        Contiguous: ``seq`` in its power-of-two bucket, K/V written into
        the slot's cache row. Paged: table set up (prefix hits mapped),
        the rest prefilled through the pool. Shared by admission and
        crash recovery (``seq`` = prompt + generated, ``replay``)."""
        if self._paged:
            start = self._pg_setup_table(slot, seq)
            tok0 = self._pg_prefill(slot, seq, start, max_new, eos_id)
            if not replay:
                self._pg_cache_insert(slot, seq)
            return tok0
        t0 = len(seq)
        tb = self._bucket(t0)
        toks = torch.zeros((1, tb), dtype=torch.long)
        toks[0, :t0] = torch.as_tensor(seq, dtype=torch.long)
        toks = toks.to(self.device)
        logits, ks, vs = llama.prefill_padded(
            self.params, toks, t0 - 1, self.cfg
        )
        self._kc[:, slot, :, :tb] = ks[:, 0].transpose(1, 2)
        self._vc[:, slot, :, :tb] = vs[:, 0].transpose(1, 2)
        return self._start_slot(slot, logits, t0, max_new, eos_id)

    def _start_slot(self, slot: int, logits: torch.Tensor, pos: int,
                    max_new: int, eos_id: Optional[int]) -> int:
        """Sample the first token from a prefill's last-row ``logits``,
        reset the slot's device decode state (next write at ``pos``, a
        ``max_new`` budget) and return the token."""
        if self._sampling:
            first = llama._categorical(logits / self.temperature, self._gen)
        else:
            first = torch.argmax(logits, dim=-1)
        first = first[0]
        eos = -1 if eos_id is None else int(eos_id)
        self._dtok[slot] = first
        self._dpos[slot] = pos
        hit = (first == eos) if eos >= 0 else torch.zeros(
            (), dtype=torch.bool, device=self.device)
        self._dact[slot] = ~hit & (max_new > 1)
        self._drem[slot] = max(max_new - 1, 0)
        self._deos[slot] = eos
        self.metrics.on_dispatch("prefill")
        return int(first)

    # -- paged KV management ------------------------------------------------
    #
    # Everything below is HOST bookkeeping over serving/paged.py:
    # allocation, prefix sharing, copy-on-write, preemption, frees. The
    # device only ever sees a block-table snapshot per dispatch.
    #
    # Eviction and reuse are safe by the order of the device's work: a
    # block dispatched with the OLD table runs before any later prefill
    # that reuses a freed block, and the new owner rewrites every
    # position before it reads it, so a stale lane's writes into a
    # reclaimed block are overwritten before they are seen. On CUDA that
    # order holds because every dispatch, block copy and host upload of
    # this engine is queued on ONE stream (the current stream); a second
    # stream would need events between them.

    def _pg_admittable(self, req: Request) -> bool:
        """Paged admission gate: the prompt's non-hit blocks must fit
        in the pool right now (free + cache-evictable). Decode growth is
        not reserved: it comes from later frees or from preempting the
        youngest slot (``pool_blocks >= m + 1`` lets a lone request
        always finish)."""
        hits = 0
        if self._prefix is not None:
            hits = len(self._prefix.match(req.prompt))
        needed = max(
            _paged.blocks_for(len(req.prompt), self.block_size) - hits, 1
        )
        avail = self._balloc.free_blocks
        if self._prefix is not None:
            avail += self._prefix.evictable()
        return avail >= needed

    def _pg_setup_table(self, slot: int, seq: List[int]) -> int:
        """Build slot ``slot``'s block table for ``seq``: map prefix-cache
        hits as SHARED entries (one ref each), allocate private blocks
        for the rest, and return the position prefill starts at. A FULL
        hit still re-prefills the last token (the first generated
        token's logits), so its shared block is copy-on-written first."""
        tbl = self._tables[slot]
        if any(b != _paged.SCRATCH for b in tbl):
            raise RuntimeError(f"slot {slot} table not clean at setup: {tbl}")
        bs = self.block_size
        hits: List[int] = []
        if self._prefix is not None:
            hits = self._prefix.match(seq)
            self._prefix.hits += len(hits)
            if not hits:
                self._prefix.misses += 1
        nb = _paged.blocks_for(len(seq), bs)
        full = nb > 0 and len(hits) == nb  # only when len(seq) % bs == 0
        start = len(seq) - 1 if full else len(hits) * bs
        for j, bid in enumerate(hits):
            self._balloc.incref(bid)
            tbl[j] = bid
        for j in range(len(hits), nb):
            tbl[j] = self._pg_alloc_or_preempt(slot)
        if full:
            self._pg_make_writable(slot, nb - 1)
        return start

    def _pg_prefill(self, slot: int, seq: List[int], start: int,
                    max_new: int, eos_id: Optional[int]) -> int:
        """Prefill positions ``start..len(seq)-1`` into the slot's mapped
        blocks and return the first generated token. With
        ``prefill_chunk`` the leading pieces run as chunk dispatches
        INLINE here (admission defers long prompts to
        ``_advance_prefills``; this loop serves replay)."""
        chunk = self.prefill_chunk
        if chunk:
            while len(seq) - start > chunk:
                self._dispatch_prefill_chunk(slot, seq, start)
                start += chunk
        return self._dispatch_prefill_final(slot, seq, start, max_new,
                                            eos_id)

    def _dispatch_prefill_chunk(self, slot: int, seq: List[int],
                                start: int) -> None:
        """One non-final prefill chunk: K/V of ``prefill_chunk`` prompt
        tokens written into the slot's blocks; no logits used, no slot
        state touched."""
        c = self.prefill_chunk
        toks = self._upload(np.asarray(seq[start:start + c])[None, :])
        table = self._upload(np.asarray(self._tables[slot]))
        llama.prefill_paged(
            self.params, toks, start, c - 1, table, self._kc, self._vc,
            self.cfg, self.block_size, **self._kv_kwargs(),
        )
        self.metrics.on_dispatch("prefill")

    def _dispatch_prefill_final(
        self, slot: int, seq: List[int], start: int, max_new: int,
        eos_id: Optional[int],
    ) -> int:
        """The bucketed TAIL of ``seq`` (positions ``start..``): prefill,
        sample the first token, reset the slot's decode state. Earlier
        positions are already resident (prefix hits / chunks)."""
        n = len(seq) - start
        tb = self._bucket(n)
        toks = np.zeros((1, tb), np.int64)
        toks[0, :n] = seq[start:]
        logits = llama.prefill_paged(
            self.params, self._upload(toks), start, n - 1,
            self._upload(np.asarray(self._tables[slot])), self._kc,
            self._vc, self.cfg, self.block_size, **self._kv_kwargs(),
        )[0]
        return self._start_slot(slot, logits, start + n, max_new, eos_id)

    def _advance_prefills(self) -> int:
        """One bounded chunk per chunk-prefilling slot per step. The
        FINAL piece lands the first token and flips the slot to
        decoding."""
        emitted = 0
        for i in range(self.max_slots):
            sl = self._slots[i]
            if sl is None or sl.pf_next is None:
                continue
            start = sl.pf_next
            if len(sl.prompt) - start > self.prefill_chunk:
                self._dispatch_prefill_chunk(i, sl.prompt, start)
                sl.pf_next = start + self.prefill_chunk
                continue
            sl.pf_next = None
            tok0 = self._dispatch_prefill_final(
                i, sl.prompt, start, sl.max_new, sl.eos_id
            )
            self._pg_cache_insert(i, sl.prompt)
            sl.generated.append(tok0)
            self.metrics.on_token(sl.rid)
            emitted += 1
            if sl.eos_id is not None and tok0 == sl.eos_id:
                self._finish(i, "eos")
            elif sl.max_new <= 1:
                self._finish(i, "done")
        return emitted

    def _pg_cache_insert(self, slot: int, prompt: List[int]) -> None:
        """Publish the slot's FULL prompt blocks into the prefix cache
        (chain keys: a hit implies the whole prefix matched). Existing
        keys are no-op touches."""
        if self._prefix is None:
            return
        tbl = self._tables[slot]
        for j, key in enumerate(_paged.chain_keys(prompt, self.block_size)):
            self._prefix.insert(key, tbl[j])

    def _ensure_cover(self, i: int) -> None:
        """Allocate on demand as ``pos`` crosses block boundaries: before
        a decode dispatch, map every block the slot's ACTIVE lane can
        write within the next ``adv * (in-flight + 1)`` positions
        (in-flight blocks move the device past the host view). Frozen
        lanes' rewrites past the budget go to scratch on the device."""
        sl = self._slots[i]
        t0 = len(sl.prompt) + len(sl.generated)
        # a horizon block moves a lane up to `horizon` positions, a
        # verify dispatch up to spec_k + 1
        adv = max(self.horizon, self.spec_k + 1)
        need = min(
            self.max_len,
            len(sl.prompt) + sl.max_new,
            t0 + adv * (len(self._inflight) + 1),
        )
        tbl = self._tables[i]
        for j in range(_paged.blocks_for(need, self.block_size)):
            if tbl[j] == _paged.SCRATCH:
                tbl[j] = self._pg_alloc_or_preempt(i)

    def _pg_alloc_or_preempt(self, slot: int) -> int:
        """One block, by any means: the free list, then evicting
        refcount-1 prefix-cache entries (LRU), then preempting the
        youngest OTHER slot back to the queue. The construction
        invariant (usable pool >= one full sequence) means a lone
        survivor always gets its block."""
        while True:
            bid = self._balloc.alloc()
            if bid is not None:
                return bid
            if self._prefix is not None and self._prefix.evict_one():
                continue
            if not self._pg_preempt(exclude=slot):
                raise RuntimeError(
                    "KV pool exhausted with nothing left to preempt"
                )

    def _pg_preempt(self, exclude: int) -> bool:
        """Preempt the youngest live slot (not ``exclude``) under pool
        pressure: free its blocks, mark the lane stale, and requeue the
        request AT THE HEAD for restart by recomputation. ``submit_s=0``
        with the ABSOLUTE deadline keeps ``deadline_at()`` right across
        the round trip."""
        victims = [
            (sl.born, i) for i, sl in enumerate(self._slots)
            if sl is not None and i != exclude
        ]
        if not victims:
            return False
        _, i = max(victims)
        sl = self._slots[i]
        log.warn("preempt", rid=sl.rid, slot=i, generated=len(sl.generated))
        self._pg_free_slot(i)
        self._slots[i] = None
        self._stale.add(i)
        self.queue.requeue_front(Request(
            rid=sl.rid, prompt=list(sl.prompt), max_new=sl.max_new,
            eos_id=sl.eos_id, deadline_s=sl.deadline, submit_s=0.0,
            recoveries=sl.recoveries, tenant=sl.tenant,
            slo_class=sl.slo_class,
        ))
        return True

    def _pg_free_slot(self, i: int) -> None:
        """Drop the slot's reference on every mapped block; free and
        table-clear happen together (a freed id left in a table would
        alias the block's next owner)."""
        tbl = self._tables[i]
        for j, bid in enumerate(tbl):
            if bid != _paged.SCRATCH:
                self._balloc.free(bid)
                tbl[j] = _paged.SCRATCH

    def _pg_make_writable(self, slot: int, j: int) -> None:
        """Copy-on-write table entry ``j``: if its block is shared
        (refcount > 1), copy it into a private block across every layer
        — scales with values under quantization — repoint the table and
        drop the shared ref."""
        tbl = self._tables[slot]
        bid = tbl[j]
        if self._balloc.refcount(bid) <= 1:
            return
        dst = self._pg_alloc_or_preempt(slot)
        for plane in (self._kc, self._vc, self._ks, self._vs):
            if plane is not None:
                plane[:, dst] = plane[:, bid]
        tbl[j] = dst
        self._balloc.free(bid)

    def _finish(self, slot: int, outcome: str) -> None:
        sl = self._slots[slot]
        if self._spec_policy is not None:
            self._spec_policy.forget(sl.rid)
        self.results[sl.rid] = RequestResult(
            rid=sl.rid, tokens=list(sl.generated), outcome=outcome
        )
        self.metrics.on_finish(sl.rid, outcome)
        # bookkeeping only: the device row already froze (or is stale);
        # paged mode returns the slot's block references to the pool
        if self._paged:
            self._pg_free_slot(slot)
        self._slots[slot] = None

    # -- crash recovery ------------------------------------------------------

    def _recover(self, err: Exception) -> None:
        """Rebuild the engine from host truth after an exception escaped
        a step: requeue a request caught mid-admission at the head,
        charge every live slot one recovery (past ``max_recoveries`` it
        finishes "failed"), drop in-flight blocks, reallocate the device
        state (pool, tables and prefix cache included), and re-prefill
        each surviving slot from ``prompt + generated``. A fault during
        recovery recurses; the per-request bound makes it terminate."""
        log.warn(
            "engine fault; recovering",
            error=f"{type(err).__name__}: {err}",
            inflight=len(self._inflight),
            live=self.active_slots,
        )
        if self._admitting is not None:
            req = self._admitting
            self._admitting = None
            req.recoveries += 1
            if req.recoveries > self.max_recoveries:
                self.results[req.rid] = RequestResult(
                    rid=req.rid, tokens=[], outcome="failed"
                )
                self.metrics.on_finish(req.rid, "failed")
            else:
                self.queue.requeue_front(req)
        live = []
        for i, sl in enumerate(self._slots):
            if sl is None:
                continue
            sl.recoveries += 1
            if sl.recoveries > self.max_recoveries:
                self._finish(i, "failed")
            else:
                live.append(i)
        self.recoveries += 1
        self.metrics.on_recovery(len(live))
        self._alloc_device_state()
        for i in live:
            try:
                self._replay_slot(i)
            except Exception as e2:  # recovery is itself a boundary
                self._recover(e2)
                return

    def _replay_slot(self, slot: int) -> None:
        """Re-prefill one live slot from ``prompt + generated``; the
        prefill emits the next token, EOS/budget re-checked. A slot
        caught mid-chunked-prefill replays its whole prompt inline (the
        fresh pool has none of its chunks)."""
        sl = self._slots[slot]
        sl.pf_next = None
        seq = sl.prompt + sl.generated
        remaining = sl.max_new - len(sl.generated)
        tok = self._prefill_into(slot, seq, remaining, sl.eos_id,
                                 replay=True)
        sl.generated.append(tok)
        self.metrics.on_token(sl.rid)
        if sl.eos_id is not None and tok == sl.eos_id:
            self._finish(slot, "eos")
        elif len(sl.generated) >= sl.max_new:
            self._finish(slot, "done")
