"""P2P weight push — warm-start a serving replica from live RAM: the
port of ``edl_tpu/elasticity/weightpush.py``.

When the elasticity controller grants chips to serving, the new
replica's weights already exist in host RAM on the pushing side (the
trainer's snapshot, or any process holding the params). Cold-loading
them from the export dir costs a full disk round trip; this module
instead serves a params-only :class:`~edl_tpu_torch.runtime.checkpoint.
LocalSnapshot` over the shard-server wire protocol
(``runtime/shard_server.py``, the ``p2p_bw_gbs`` path) and lets the
replica pull it on spawn (``python -m edl_tpu_torch fleet --replica
--warm-from p2p --warm-addr host:port``).

The pushed params are torch tensors (a bfloat16 leaf travels as the
uint16 view the shard plane holds bf16 in, named ``"bfloat16"``, the
reference's bytes); the fetched ones come back as CPU tensors of the
advertised dtypes.

The model-architecture doc rides along as a ``__config__`` piece
(JSON bytes as a uint8 array), so the puller rebuilds the matching
module with no side channel — the same self-describing trick the
export manifest plays, but over the wire.

Failure is loud by design: a replica asked to warm-start MUST NOT fall
back to a silent cold init — it would come up serving *different
weights* than the fleet believes it has. ``fetch_params`` raises; the
replica exits nonzero; the supervisor's spawn retry handles it.
"""

from __future__ import annotations

import json
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from edl_tpu_torch.runtime.checkpoint import (
    LocalSnapshot,
    _leaf_keys,
    _parse_piece_key,
    host_array,
)
from edl_tpu_torch.runtime.shard_server import (RemotePieces, ShardServer,
                                                fetch_index)
from edl_tpu_torch.utils.logging import kv_logger

log = kv_logger("weightpush")

CONFIG_KEY = "__config__"


def params_snapshot(
    params: Any, config_doc: Dict[str, Any], step: int = 0
) -> LocalSnapshot:
    """Params-only snapshot: every leaf as one full-extent piece at
    zero offset (host-RAM copies), plus the ``__config__`` piece.
    Leaf keys carry the ``p:`` prefix shared with the checkpoint
    formats, so a full training ShardServer and this one are
    interchangeable sources for the params subset."""
    items = [(f"p:{k}", host_array(v.detach().cpu().contiguous()))
             for k, v in _leaf_keys(params)]
    cfg = np.frombuffer(json.dumps(config_doc).encode(), dtype=np.uint8)
    items.append((CONFIG_KEY, (cfg, cfg.dtype.name)))
    pieces: Dict[str, Any] = {}
    primary: Dict[str, Any] = {}
    shapes: Dict[str, Tuple[int, ...]] = {}
    dtypes: Dict[str, str] = {}
    host_only: Dict[str, bool] = {}
    for key, (arr, name) in items:
        off = tuple(0 for _ in arr.shape)
        pieces[key] = [(off, arr)]
        primary[key] = [off]
        shapes[key] = tuple(arr.shape)
        dtypes[key] = name
        host_only[key] = True
    return LocalSnapshot(
        step=step,
        pieces=pieces,
        primary=primary,
        shapes=shapes,
        dtypes=dtypes,
        host_only=host_only,
    )


def serve_params(
    params: Any,
    config_doc: Dict[str, Any],
    *,
    step: int = 0,
    token: Optional[str] = None,
    host: Optional[str] = None,
) -> ShardServer:
    """Stand up a ShardServer over a params snapshot taken NOW (the
    snapshot is fixed — rolling weight generations restart the server).
    Returns the live server; ``.port`` is the ephemeral bind."""
    snap = params_snapshot(params, config_doc, step=step)
    check = (lambda t: t == token) if token is not None else None
    srv = ShardServer(lambda: snap, check_token=check, host=host)
    log.info("serving params", port=srv.port, step=step,
             leaves=len(snap.pieces) - 1)
    return srv


def _unflatten(flat: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """Rebuild the nested dict tree from the '/'-joined leaf keys.
    Dict-structured trees only — which is what every model in
    edl_tpu_torch.models ships (stacked-layer dicts, no lists)."""
    out: Dict[str, Any] = {}
    for key, arr in flat.items():
        node = out
        parts = key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = arr
    return out


def fetch_params(
    addr: str,
    *,
    token: Optional[str] = None,
    timeout_s: float = 5.0,
    nconn: Optional[int] = None,
) -> Tuple[Dict[str, Any], Optional[Dict[str, Any]], int]:
    """Pull ``(params, config_doc, step)`` from a peer's ShardServer —
    the port's or the reference's; the params are CPU tensors over the
    received buffers (no copy).

    Works against a dedicated :func:`serve_params` server *or* a full
    training-snapshot server (the ``o:`` optimizer leaves are simply
    skipped; ``config_doc`` is then None and the caller supplies the
    architecture). Raises ``ConnectionError`` when the peer is
    unreachable — never a silent empty tree."""
    idx = fetch_index(addr, timeout_s=timeout_s, token=token)
    if idx is None:
        raise ConnectionError(f"no shard server answering at {addr}")
    step, entries = idx
    want = {
        e: dt
        for e, dt in entries.items()
        if e.startswith("p:") or e.startswith(CONFIG_KEY + "@")
    }
    if not any(e.startswith("p:") for e in want):
        raise ConnectionError(
            f"shard server at {addr} holds no param pieces "
            f"({len(entries)} entries)"
        )
    src = RemotePieces(addr, want, token=token, nconn=nconn)
    try:
        got = src.get_many(want.keys())
    finally:
        src.close()
    config_doc: Optional[Dict[str, Any]] = None
    flat: Dict[str, torch.Tensor] = {}
    for entry, arr in got.items():
        key, off, _shape = _parse_piece_key(entry)
        if key == CONFIG_KEY:
            config_doc = json.loads(arr.tobytes().decode())
            continue
        if any(off):
            # a sharded training server may expose partial pieces; the
            # warm path only supports full-extent leaves (the pusher
            # holds whole params) — loud, not wrong
            raise ValueError(
                f"partial piece {entry}: p2p warm-start needs "
                "full-extent leaves (use a params_snapshot server)"
            )
        t = torch.from_numpy(arr)
        flat[key[2:]] = (t.view(torch.bfloat16) if want[entry] == "bfloat16"
                         else t)
    log.info("fetched params", addr=addr, leaves=len(flat), step=step,
             bytes=sum(int(t.nbytes) for t in flat.values()))
    return _unflatten(flat), config_doc, step
