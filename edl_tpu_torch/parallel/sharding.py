"""Host staging of device state — the one-device part of the port of
``edl_tpu/parallel/sharding.py``: :func:`to_host` (device → host RAM,
the snapshot half of the reshard protocol) and :func:`stream_reshard`
(device → host → device as one overlapped pipeline, the host fallback
of a reshard).

The reference moves ``jax.Array`` pieces with ``copy_to_host_async``
and ``device_put``. Here a piece goes device → pinned host memory on a
download stream and host → device on an upload stream, ordered by CUDA
events only, so the host never waits inside the pipeline and the two
copy directions overlap (the stall is ~max(d2h, h2d), not the sum).
Policies shared with the reference: leaves over 2 x ``_CHUNK_BYTES``
(and with more than one row) are cut into row pieces of about
``_CHUNK_BYTES``, and at most ``_CHUNK_WINDOW`` pieces are in flight:
they are the slots of one pinned staging ring, and a slot's next
download waits on the event of its last upload. Sharded leaves (a mesh)
wait for the mesh slice (ROADMAP Queue A item 2b).
"""

from __future__ import annotations

from typing import Any, List, Optional, Sequence, Tuple

import torch

from edl_tpu_torch.utils.device import DeviceLike, resolve_device
from edl_tpu_torch.utils.tree import leaves as _leaves
from edl_tpu_torch.utils.tree import replace_leaves

_CHUNK_BYTES = 8 << 20  # split large leaves into ~8 MB row pieces
_CHUNK_WINDOW = 8  # pieces in flight: the slots of the pinned ring


def to_host(tree) -> Any:
    """Fetch a tree of tensors to host memory (pinned where a leaf comes
    from the card): every device → host copy is queued on one download
    stream before the host waits once. Whole leaves, not pieces: a copy
    lands in its final host buffer, so pieces would only add copies
    (the reference pieces leaves to open concurrent streams on slow
    links; one copy engine serves them in turn here). CPU leaves are
    cloned."""
    leaves = [x.detach() for x in _leaves(tree)]
    # pinned only where a card takes part (pinning needs the runtime)
    outs = [torch.empty(x.shape, dtype=x.dtype, pin_memory=x.is_cuda)
            for x in leaves]
    cuda = [x.is_cuda for x in leaves]
    if any(cuda):
        down = torch.cuda.Stream()
        down.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(down):
            for x, o, c in zip(leaves, outs, cuda):
                if c:
                    o.copy_(x, non_blocking=True)
        down.synchronize()
    for x, o, c in zip(leaves, outs, cuda):
        if not c:
            o.copy_(x)
    return replace_leaves(tree, outs)


def _schedule(leaves: Sequence[torch.Tensor]
              ) -> List[Tuple[int, Optional[int], Optional[int]]]:
    """(leaf index, row start, row end) pieces; None rows = the whole
    leaf. The reference's rule: a leaf over 2 x ``_CHUNK_BYTES`` with
    more than one row is cut into min(rows, max(2, bytes //
    _CHUNK_BYTES)) pieces of equal row count (the last ragged)."""
    out = []
    for i, x in enumerate(leaves):
        nbytes = x.numel() * x.element_size()
        rows = None
        if nbytes > 2 * _CHUNK_BYTES and x.dim() and x.shape[0] > 1:
            n = min(x.shape[0], max(2, nbytes // _CHUNK_BYTES))
            rows = -(-x.shape[0] // n)
        if rows is None or rows >= x.shape[0]:
            out.append((i, None, None))
        else:
            for s in range(0, x.shape[0], rows):
                out.append((i, s, min(s + rows, x.shape[0])))
    return out


def stream_reshard(leaves: Sequence[torch.Tensor],
                   targets: Sequence[DeviceLike]) -> List[torch.Tensor]:
    """Device → host → device as ONE overlapped pipeline: leaf ``i``
    lands as a new tensor on ``targets[i]`` (a device, CUDA or CPU),
    through host memory. Pieces (:func:`_schedule`) rotate through a
    pinned ring of ``_CHUNK_WINDOW`` slots: a download is queued on the
    download stream behind the upload that last used its slot, an upload
    on the upload stream behind its own download. CPU sides copy on the
    host (waiting on the piece's event first). The caller's stream waits
    on both streams before this returns, so its next op sees every
    placed leaf; the host does not wait for the copies."""
    leaves = [x.detach() for x in leaves]
    devs = [resolve_device(t) for t in targets]
    sched = _schedule(leaves)
    outs = [torch.empty(x.shape, dtype=x.dtype, device=d)
            for x, d in zip(leaves, devs)]
    cuda = any(x.is_cuda for x in leaves) or any(d.type == "cuda"
                                                 for d in devs)
    align = 64

    def piece(t, s, e):
        return t if s is None else t[s:e]

    sizes = [piece(leaves[i], s, e).numel() * leaves[i].element_size()
             for i, s, e in sched]
    slot_bytes = -(-max(sizes, default=1) // align) * align
    n_slots = max(1, min(_CHUNK_WINDOW, len(sched)))
    ring = torch.empty(n_slots * slot_bytes, dtype=torch.uint8,
                       pin_memory=cuda)
    if cuda:
        cur = torch.cuda.current_stream()
        down, up = torch.cuda.Stream(), torch.cuda.Stream()
        down.wait_stream(cur)  # sources are written on the caller's stream
        up.wait_stream(cur)  # and so are the fresh outputs
    freed: List[Optional[torch.cuda.Event]] = [None] * n_slots
    for k, ((i, s, e), size) in enumerate(zip(sched, sizes)):
        src = piece(leaves[i], s, e)
        dst = piece(outs[i], s, e)
        j = k % n_slots
        slot = ring[j * slot_bytes: j * slot_bytes + size]
        slot = slot.view(src.dtype).view(src.shape)
        landed = None
        if src.is_cuda:
            with torch.cuda.stream(down):
                if freed[j] is not None:
                    down.wait_event(freed[j])
                slot.copy_(src, non_blocking=True)
                landed = torch.cuda.Event()
                landed.record(down)
        else:
            if freed[j] is not None:
                freed[j].synchronize()
            slot.copy_(src)
        if dst.is_cuda:
            with torch.cuda.stream(up):
                if landed is not None:
                    up.wait_event(landed)
                dst.copy_(slot, non_blocking=True)
                freed[j] = torch.cuda.Event()
                freed[j].record(up)
        else:
            if landed is not None:
                landed.synchronize()
            dst.copy_(slot)
            freed[j] = None
    if cuda:
        cur.wait_stream(down)
        cur.wait_stream(up)
    return outs
