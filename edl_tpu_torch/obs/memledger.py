"""Device memory ledger — who holds card memory, by category, live:
the port's copy of ``edl_tpu/obs/memledger.py``.

The serving and training processes hold a handful of LONG-LIVED device
allocations that between them decide what fits on a card: the param
tree, optimizer moments, per-engine KV caches, device slot state. The
ledger makes them a scrapeable balance sheet —

* ``edl_hbm_bytes{category}``   — bytes registered per category
  (``params`` / ``opt`` / ``kv`` / ``slot_state`` / …)
* ``edl_kv_occupancy_ratio``    — used KV tokens (contiguous) or
  allocated blocks (paged) over capacity across registered engines,
  plus ``edl_kv_blocks_free``, ``edl_kv_bytes_per_token`` and
  ``edl_kv_prefix_hit_total`` for paged engines.

Semantics that make it drift-proof:

* **keyed, replace-on-reregister** — entries are ``(owner, name)``
  keys; registering the same key REPLACES the old entry (delta applied
  to the category gauge). The engine's ``_recover`` →
  ``_alloc_device_state`` re-registers its cache under the same key,
  so a crash/recover cycle cannot double-count.
* **owner-scoped release** — ``release_owner(owner)`` drops every
  entry (and KV usage) an object registered; engines attach it via
  ``weakref.finalize`` so a garbage-collected engine cannot leave
  ghost bytes on the gauge.
* **cross-checkable** — :meth:`MemoryLedger.crosscheck` compares the
  ledger total against ``torch.cuda.memory_allocated`` on a card:
  ``live - ledger`` is the unaccounted transient pool.

torch-free at module scope; :func:`tree_nbytes` walks any
dict/list/tuple tree of objects exposing ``.nbytes`` (torch tensors,
numpy arrays, the int8 ``{"q8", "s8"}`` weight records) without
importing anything.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, Optional, Tuple

from edl_tpu_torch.obs import metrics as obs_metrics


def tree_nbytes(tree: Any) -> int:
    """Total ``.nbytes`` over a nested dict/list/tuple of array-likes.
    Non-array leaves (None, scalars, configs) count zero — the ledger
    measures device buffers, not bookkeeping."""
    if tree is None:
        return 0
    if isinstance(tree, dict):
        return sum(tree_nbytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(tree_nbytes(v) for v in tree)
    n = getattr(tree, "nbytes", None)
    return int(n) if isinstance(n, (int, float)) else 0


class MemoryLedger:
    """Thread-safe registry of long-lived device allocations."""

    def __init__(self, registry: Optional[obs_metrics.MetricsRegistry] = None):
        r = registry or obs_metrics.default_registry()
        self._lock = threading.Lock()
        # (owner, name) -> (category, nbytes)
        self._entries: Dict[Tuple[str, str], Tuple[str, int]] = {}
        self._by_category: Dict[str, int] = {}
        # owner -> (used_tokens, capacity_tokens) for KV occupancy
        self._kv_usage: Dict[str, Tuple[int, int]] = {}
        self._g_bytes = r.gauge(
            "edl_hbm_bytes",
            "bytes of registered long-lived device allocations by "
            "category (obs/memledger.py)",
            ("category",),
        )
        self._g_kv_occ = r.gauge(
            "edl_kv_occupancy_ratio",
            "used KV-cache tokens (contiguous) or allocated blocks "
            "(paged) over capacity across registered engines",
        )
        # owner -> free block count (paged engines only)
        self._kv_blocks_free: Dict[str, int] = {}
        self._g_kv_free = r.gauge(
            "edl_kv_blocks_free",
            "free KV pool blocks across registered paged engines — the "
            "headroom admission gates on",
        )
        # owner -> (pool bytes incl. scales, capacity tokens): the
        # quantized-KV shrink, scrapeable as bytes per resident token
        self._kv_bpt: Dict[str, Tuple[int, int]] = {}
        self._g_kv_bpt = r.gauge(
            "edl_kv_bytes_per_token",
            "KV pool bytes (values + quantization scales) per token of "
            "pool capacity across registered paged engines — 2-4x lower "
            "under --kv-quant int8/int4",
        )
        self._c_prefix_hits = r.counter(
            "edl_kv_prefix_hit_total",
            "prefix-cache block hits: prompt blocks served from the "
            "shared KV pool instead of re-prefilled",
        )

    # -- allocations --------------------------------------------------------

    def register(
        self, owner: str, name: str, nbytes: float, category: str
    ) -> None:
        """Record (or REPLACE — same key never double-counts) one
        allocation."""
        nbytes = int(nbytes)
        key = (owner, name)
        with self._lock:
            old = self._entries.get(key)
            if old is not None:
                self._by_category[old[0]] = (
                    self._by_category.get(old[0], 0) - old[1]
                )
            self._entries[key] = (category, nbytes)
            self._by_category[category] = (
                self._by_category.get(category, 0) + nbytes
            )
            touched = {category} | ({old[0]} if old else set())
            totals = {c: self._by_category.get(c, 0) for c in touched}
        for c, v in totals.items():
            self._g_bytes.set(v, category=c)

    def register_tree(
        self, owner: str, name: str, tree: Any, category: str
    ) -> int:
        """Register a pytree's summed bytes; returns the figure."""
        n = tree_nbytes(tree)
        self.register(owner, name, n, category)
        return n

    def release(self, owner: str, name: str) -> int:
        """Drop one entry; returns the bytes released (0 if absent)."""
        key = (owner, name)
        with self._lock:
            old = self._entries.pop(key, None)
            if old is None:
                return 0
            cat, n = old
            self._by_category[cat] = self._by_category.get(cat, 0) - n
            total = self._by_category[cat]
        self._g_bytes.set(total, category=cat)
        return n

    def release_owner(self, owner: str) -> int:
        """Drop every entry (and KV usage) registered under ``owner``
        — the engine's weakref.finalize hook. Returns bytes released."""
        with self._lock:
            keys = [k for k in self._entries if k[0] == owner]
            released = 0
            touched = set()
            for k in keys:
                cat, n = self._entries.pop(k)
                self._by_category[cat] = self._by_category.get(cat, 0) - n
                released += n
                touched.add(cat)
            self._kv_usage.pop(owner, None)
            self._kv_blocks_free.pop(owner, None)
            self._kv_bpt.pop(owner, None)
            totals = {c: self._by_category.get(c, 0) for c in touched}
            used = sum(u for u, _ in self._kv_usage.values())
            cap = sum(c for _, c in self._kv_usage.values())
            free = sum(self._kv_blocks_free.values())
            bpt_b = sum(b for b, _ in self._kv_bpt.values())
            bpt_t = sum(t for _, t in self._kv_bpt.values())
        for c, v in totals.items():
            self._g_bytes.set(v, category=c)
        self._g_kv_occ.set(used / cap if cap else 0.0)
        self._g_kv_free.set(free)
        self._g_kv_bpt.set(bpt_b / bpt_t if bpt_t else 0.0)
        return released

    # -- KV occupancy -------------------------------------------------------

    def set_kv_usage(self, owner: str, used_tokens: int, capacity_tokens: int):
        """One engine's live KV occupancy (prompt+generated tokens over
        slots×max_len); the gauge aggregates across engines. Called
        per engine step — one lock + two dict hits."""
        with self._lock:
            self._kv_usage[owner] = (int(used_tokens), int(capacity_tokens))
            used = sum(u for u, _ in self._kv_usage.values())
            cap = sum(c for _, c in self._kv_usage.values())
        self._g_kv_occ.set(used / cap if cap else 0.0)

    def set_kv_blocks_free(self, owner: str, free_blocks: int) -> None:
        """One paged engine's free-block headroom; the gauge aggregates
        across engines (contiguous engines never call this)."""
        with self._lock:
            self._kv_blocks_free[owner] = int(free_blocks)
            total = sum(self._kv_blocks_free.values())
        self._g_kv_free.set(total)

    def set_kv_bytes_per_token(
        self, owner: str, pool_bytes: int, capacity_tokens: int
    ) -> None:
        """One paged engine's pool bytes (values + scales) over its
        token capacity; the gauge publishes the byte-weighted average
        across engines — the figure ``--kv-quant`` shrinks 2-4x."""
        with self._lock:
            self._kv_bpt[owner] = (int(pool_bytes), int(capacity_tokens))
            b = sum(x for x, _ in self._kv_bpt.values())
            t = sum(y for _, y in self._kv_bpt.values())
        self._g_kv_bpt.set(b / t if t else 0.0)

    def count_prefix_hits(self, n: int = 1) -> None:
        """Count ``n`` prompt blocks served from the shared prefix
        cache (prefill skipped for those positions)."""
        self._c_prefix_hits.inc(n)

    # -- views --------------------------------------------------------------

    def total(self, category: Optional[str] = None) -> int:
        with self._lock:
            if category is not None:
                return self._by_category.get(category, 0)
            return sum(n for _, n in self._entries.values())

    def owner_total(self, owner: str, category: Optional[str] = None) -> int:
        """Bytes one owner has registered (optionally one category) —
        what the chaos lane pins across crash/recover cycles."""
        with self._lock:
            return sum(
                n
                for (o, _), (c, n) in self._entries.items()
                if o == owner and (category is None or c == category)
            )

    def categories(self) -> Dict[str, int]:
        with self._lock:
            return {c: n for c, n in self._by_category.items() if n}

    def kv_occupancy(self) -> float:
        with self._lock:
            used = sum(u for u, _ in self._kv_usage.values())
            cap = sum(c for _, c in self._kv_usage.values())
        return used / cap if cap else 0.0

    def crosscheck(self) -> Optional[Dict[str, float]]:
        """Compare the ledger against ``torch.cuda.memory_allocated`` of
        the current card. ``unaccounted`` (live − ledger) is the
        transient pool: activations in flight, the caching allocator's
        live temporaries. None without a card (the CPU has no device
        allocator to read)."""
        import torch

        if not torch.cuda.is_available():
            return None
        live = torch.cuda.memory_allocated()
        ledger = self.total()
        return {
            "ledger_bytes": float(ledger),
            "live_bytes": float(live),
            "unaccounted_bytes": float(live - ledger),
        }


# ---------------------------------------------------------------------------
# process-wide default (mirrors obs.metrics' default-registry pattern)

_default = MemoryLedger()
_default_lock = threading.Lock()


def default_ledger() -> MemoryLedger:
    return _default


def reset_default_ledger(
    registry: Optional[obs_metrics.MetricsRegistry] = None,
) -> MemoryLedger:
    """Swap in a fresh default ledger (tests); returns the new one.
    Pass the registry its gauges should publish into (tests that also
    reset the default metrics registry should pass the new one)."""
    global _default
    with _default_lock:
        _default = MemoryLedger(registry)
    return _default
