"""Elastic runtime — the one-device part of the port of
``edl_tpu/runtime/elastic.py``: :func:`device_reshard`, the fast path
of a rescale. ``ElasticTrainer`` (snapshot → remesh → reshard between
steps, the host fallback, ``request_rescale``) waits for the mesh slice
(ROADMAP Queue A item 2b).
"""

from __future__ import annotations

import torch

from edl_tpu_torch.train.trainer import (TrainState, leaves,
                                         optimizer_tensors, shard_state)
from edl_tpu_torch.utils.device import DeviceLike, resolve_device


def device_reshard(state: TrainState, plan=None, mesh=None,
                   device: DeviceLike = None) -> TrainState:
    """Place a live device-resident TrainState on ``device`` (CUDA
    unless ``"cpu"`` is named) and fence. Where every tensor already
    lies there it moves nothing and returns ``state`` itself, as the
    reference's ``device_put`` onto the same sharding does; otherwise
    it is :func:`~trainer.shard_state`. A sharding ``plan``/``mesh``
    raises."""
    dev = resolve_device(device)
    ts = leaves(state.params) + [t for _, _, t, host in
                                 optimizer_tensors(state) if not host]
    if plan is not None or mesh is not None or any(t.device != dev
                                                  for t in ts):
        state = shard_state(state, plan, mesh, dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return state
