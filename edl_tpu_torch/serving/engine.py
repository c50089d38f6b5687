"""Continuous-batching generation engine — the port of
``edl_tpu/serving/engine.py``, contiguous KV path.

A fixed table of ``max_slots`` KV slots decodes every active request in
one batched step; new requests prefill into free slots and finished
ones leave BETWEEN blocks. Decode runs in fused HORIZON blocks
(``llama.decode_horizon_slots``: H steps per dispatch, per-slot EOS /
budget termination on the device), and the host pipeline is double
buffered: block k+1 is queued before block k's token matrix is read.

How the reference's JAX mechanics map onto PyTorch:

* **Donation becomes in-place.** The reference donates ``kc``/``vc``
  to XLA and asserts the old buffers died. Here the KV cache is one
  pair of tensors, written in place by the prefill (slice assignment
  into the slot row) and by every decode step (unique-index
  ``index_put``); there is nothing to assert.
* **The double buffer.** A plain ``.cpu()`` of block k's tokens, made
  after block k+1 was queued, would wait for k+1 too. So at dispatch
  the engine queues a ``non_blocking`` copy of the token matrix into
  pinned host memory and records a ``torch.cuda.Event``; the drain
  waits on that event only.
* **Programs need no memo.** PyTorch runs eagerly; the prefill still
  pads prompts into power-of-two buckets (``_bucket``), which keeps the
  attention on the flash kernel's supported lengths exactly as the
  reference does.

Greedy decode is token-identical to sequential ``llama.generate`` at
every horizon, with mid-stream joins, EOS inside a block and deadline
evictions. Any exception escaping a step triggers :meth:`_recover`: the
device state is rebuilt and every live slot re-prefilled from
``prompt + generated`` (greedy replay is token-identical), with the
per-request ``max_recoveries`` bound. Temperature sampling draws from
the engine's own seeded ``torch.Generator``.

Not ported yet (each raises in the constructor and is queued in
ROADMAP Queue A): the paged KV cache (``block_size``, ``prefix_cache``,
``prefill_chunk``), quantized KV (``kv_quant``) and speculative decoding
(``spec_k``); and the reference's observability hooks (compile watch,
cost model, memory ledger, flight recorder, tracing, fault points).
"""

from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Deque, Dict, List, Optional

import torch

from edl_tpu_torch.models import llama
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

_NOT_PORTED = (
    "not ported yet (ROADMAP Queue A item 3: paged, kv-quant and "
    "speculative serving modes)"
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


@dataclass
class RequestResult:
    rid: str
    tokens: List[int]
    outcome: str  # done | eos | timeout | failed


@dataclass
class _Block:
    """One dispatched, not yet drained horizon block."""

    host: torch.Tensor  # [B, H] token matrix (pinned host copy on CUDA)
    ready: Optional[torch.cuda.Event]  # None on the CPU
    t_dispatch: float
    members: Dict[int, str]  # lane -> rid of its occupant at dispatch


class ContinuousBatchingEngine:
    """In-process continuous-batching server over a llama param tree
    (dense, in ``cfg.dtype``, on ``device``). The KV cache is
    [L, max_slots, max_len, KV, hd] in ``cfg.dtype``, allocated once and
    updated in place.

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
        prefix_cache: bool = False,
        prefill_chunk: int = 0,
        kv_quant: str = "off",
        spec_k: int = 0,
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
        for name, val, off in (
            ("block_size", block_size, 0),
            ("prefix_cache", prefix_cache, False),
            ("prefill_chunk", prefill_chunk, 0),
            ("kv_quant", kv_quant, "off"),
            ("spec_k", spec_k, 0),
        ):
            if val != off:
                raise NotImplementedError(f"{name}={val!r}: {_NOT_PORTED}")
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
        self._slots: List[Optional[_Slot]] = [None] * max_slots
        # popped from the queue but not yet slotted — requeued at the
        # head if the admission prefill raises
        self._admitting: Optional[Request] = None
        self._draining = False
        self._kc: Optional[torch.Tensor] = None
        self._vc: Optional[torch.Tensor] = None
        self._alloc_device_state()
        log.info(
            "engine ready", slots=max_slots, max_len=max_len,
            horizon=horizon, device=str(self.device),
            cache_mb=round(2 * self._kc.nbytes / 2**20, 1),
            sampling=self._sampling,
        )

    def _alloc_device_state(self) -> None:
        """(Re)allocate the slot decode state, the KV cache and the
        in-flight queue — at construction and in :meth:`_recover`."""
        cfg, n, dev = self.cfg, self.max_slots, self.device
        self._dtok = torch.zeros(n, dtype=torch.long, device=dev)
        self._dpos = torch.zeros(n, dtype=torch.long, device=dev)
        self._dact = torch.zeros(n, dtype=torch.bool, device=dev)
        self._drem = torch.zeros(n, dtype=torch.long, device=dev)
        self._deos = torch.full((n,), -1, dtype=torch.long, device=dev)
        shape = (cfg.n_layers, n, self.max_len, cfg.n_kv_heads, cfg.head_dim)
        self._kc = self._vc = None  # free the old cache before the new one
        self._kc = torch.zeros(shape, dtype=cfg.dtype, device=dev)
        self._vc = torch.zeros(shape, dtype=cfg.dtype, device=dev)
        # lanes deadline-evicted while their device row still decoded:
        # blocks dispatched before the eviction carry the old request's
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
        """One iteration: admit up to the block budget, dispatch ONE
        horizon block over every active slot, drain the PREVIOUS block
        while the new one runs. Returns tokens observed this iteration.
        An exception escaping the iteration triggers :meth:`_recover`
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
        self.metrics.on_step(self.active_slots, self.max_slots,
                             self.queue.depth)
        if self.active_slots:
            self._dispatch_block()
            while len(self._inflight) > 1:
                emitted += self._drain_one()
        else:
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

    def _dispatch_block(self) -> None:
        (toks, self._dtok, self._dpos, self._dact, self._drem,
         self._kc, self._vc) = llama.decode_horizon_slots(
            self.params, self._dtok, self._dpos, self._dact, self._drem,
            self._deos, self._kc, self._vc, self.cfg,
            horizon=self.horizon, generator=self._gen,
            temperature=self.temperature if self._sampling else 1.0,
            sampling=self._sampling,
        )
        self.metrics.on_dispatch("decode")
        host, ev = self._to_host(toks)
        members = {
            i: s.rid for i, s in enumerate(self._slots) if s is not None
        }
        self._inflight.append(_Block(host, ev, self.clock(), members))

    def _drain_one(self) -> int:
        """Read the OLDEST in-flight block's [B, H] token matrix and
        replay it into the host bookkeeping. Frozen lanes read -1."""
        blk = self._inflight.popleft()
        if blk.ready is not None:
            blk.ready.synchronize()
        out = blk.host.numpy()
        self.metrics.on_block(self.clock() - blk.t_dispatch)
        emitted = 0
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
            if outcome:
                self._finish(i, outcome)
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
            self.metrics.on_pop(req.rid)
            slot = free.pop(0)
            self._admitting = req
            if slot in self._stale and self._inflight:
                emitted += self._drain_all()
            self._stale.discard(slot)
            tok0 = self._prefill_into(slot, req.prompt, req.max_new,
                                      req.eos_id)
            self.metrics.on_admit(req.rid, len(req.prompt))
            sl = _Slot(
                rid=req.rid, prompt=list(req.prompt), max_new=req.max_new,
                eos_id=req.eos_id, generated=[tok0],
                deadline=req.deadline_at(),
                tenant=req.tenant, slo_class=req.slo_class,
            )
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
        self, slot: int, seq: List[int], max_new: int, eos_id: Optional[int]
    ) -> int:
        """Prefill ``seq`` in its power-of-two bucket, write its K/V into
        cache row ``slot`` in place, reset the row's decode state to a
        ``max_new`` budget, and return the first token (a host sync by
        design: the first token IS the TTFT sample). Shared by admission
        and crash recovery (``seq`` = prompt + generated)."""
        t0 = len(seq)
        tb = self._bucket(t0)
        toks = torch.zeros((1, tb), dtype=torch.long)
        toks[0, :t0] = torch.as_tensor(seq, dtype=torch.long)
        toks = toks.to(self.device)
        logits, ks, vs = llama.prefill_padded(
            self.params, toks, t0 - 1, self.cfg
        )
        self._kc[:, slot, :tb] = ks[:, 0]
        self._vc[:, slot, :tb] = vs[:, 0]
        if self._sampling:
            first = llama._categorical(logits / self.temperature, self._gen)
        else:
            first = torch.argmax(logits, dim=-1)
        first = first[0]
        eos = -1 if eos_id is None else int(eos_id)
        self._dtok[slot] = first
        self._dpos[slot] = t0
        hit = (first == eos) if eos >= 0 else torch.zeros(
            (), dtype=torch.bool, device=self.device)
        self._dact[slot] = ~hit & (max_new > 1)
        self._drem[slot] = max(max_new - 1, 0)
        self._deos[slot] = eos
        self.metrics.on_dispatch("prefill")
        return int(first)

    def _finish(self, slot: int, outcome: str) -> None:
        sl = self._slots[slot]
        self.results[sl.rid] = RequestResult(
            rid=sl.rid, tokens=list(sl.generated), outcome=outcome
        )
        self.metrics.on_finish(sl.rid, outcome)
        # bookkeeping only: the device row already froze (or is stale),
        # and the next prefill into this slot overwrites its cache row
        self._slots[slot] = None

    # -- crash recovery ------------------------------------------------------

    def _recover(self, err: Exception) -> None:
        """Rebuild the engine from host truth after an exception escaped
        a step: requeue a request caught mid-admission at the head,
        charge every live slot one recovery (past ``max_recoveries`` it
        finishes "failed"), drop in-flight blocks, reallocate the device
        state, and re-prefill each surviving slot from
        ``prompt + generated``. A fault during recovery recurses; the
        per-request bound makes it terminate."""
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
        prefill emits the next token, EOS/budget re-checked."""
        sl = self._slots[slot]
        seq = sl.prompt + sl.generated
        remaining = sl.max_new - len(sl.generated)
        tok = self._prefill_into(slot, seq, remaining, sl.eos_id)
        sl.generated.append(tok)
        self.metrics.on_token(sl.rid)
        if sl.eos_id is not None and tok == sl.eos_id:
            self._finish(slot, "eos")
        elif len(sl.generated) >= sl.max_new:
            self._finish(slot, "done")
