"""Pipeline parallelism — the port of ``edl_tpu/parallel/pipeline.py``:
the GPipe fill-drain schedule over the ``pp`` axis of a mesh of
processes.

Each rank of the pp group holds one stage's parameters. A step runs
``n_micro + pp - 1`` ticks; in tick ``t`` stage ``s`` runs microbatch
``t - s`` when there is one (stage 0 reads it from the input, the
others from what their predecessor sent), then every stage that ran
sends its activation to the next one (``collectives.exchange``, one
ppermute of the pairs that carry a real microbatch). Unlike the
reference, whose every stage computes every tick and discards the
bubble's results, a rank computes only the ticks in which it holds a
real microbatch: the same result with no wasted stage passes.

The backward is the reverse schedule, run explicitly (one
``torch.autograd.Function``): ticks in reverse order, each stage taking
its output's gradient (the last stage from the loss, the others from
their successor), running its stage's backward for that microbatch
(``torch.autograd.grad`` over the graph its forward kept) and sending
the input's gradient to its predecessor. Cross-process autograd cannot
do this: a stage whose output only leaves for the next stage has no
path to its own loss, so autograd would never run the backward of its
send, and its successor would wait forever for the gradient's receiver.
Stage parameters' gradients sum over the microbatches.
"""

from __future__ import annotations

from typing import Any, Callable, List

import torch

from edl_tpu_torch.parallel import collectives as coll
from edl_tpu_torch.parallel import sharding as shd
from edl_tpu_torch.utils.tree import leaves as _leaves
from edl_tpu_torch.utils.tree import replace_leaves


def _stage_leaf(leaf: torch.Tensor, n: int, stage: int, axis: str
                ) -> torch.Tensor:
    """This rank's stage of a leaf with leading dim ``n`` stages: a
    placed slice whose dim 0 is split over ``axis`` (one stage here), or
    a whole ``[n, ...]`` stack (indexed here)."""
    inf = shd.info(leaf)
    if inf is not None and axis in inf.dim_axes(0):
        lead = inf.shape[0]
        if lead != n or leaf.shape[0] != 1:
            raise ValueError(
                f"stage param leading dim {lead} != {axis} axis size {n}")
        return leaf[0]
    if leaf.shape[0] != n:
        raise ValueError(
            f"stage param leading dim {leaf.shape[0]} != {axis} axis size "
            f"{n}")
    return leaf[stage]


class _Schedule:
    """What the forward and backward of one pipeline call share."""

    def __init__(self, stage_fn, tree, group, n_micro):
        self.stage_fn, self.tree, self.group = stage_fn, tree, group
        self.n, self.stage = group.size, group.rank
        self.n_micro = n_micro
        self.ticks = n_micro + self.n - 1
        self.ins: List[torch.Tensor] = []
        self.outs: List[torch.Tensor] = []

    def real(self, t: int, s: int) -> bool:
        return 0 <= t - s < self.n_micro

    def forward_pairs(self, t: int):
        return [(s, s + 1) for s in range(self.n - 1) if self.real(t, s)]


class _Pipeline(torch.autograd.Function):
    @staticmethod
    def forward(ctx, sched: _Schedule, x, *params):
        stage, last = sched.stage, sched.n - 1
        held = [p.detach().requires_grad_(p.requires_grad) for p in params]
        tree = replace_leaves(sched.tree, held)
        mb = x[0]
        out = (torch.empty((sched.n_micro,) + tuple(mb.shape),
                           dtype=mb.dtype, device=mb.device)
               if stage == last else None)
        buf = y = None
        # a graph per microbatch only when a gradient is wanted
        with torch.set_grad_enabled(any(ctx.needs_input_grad)):
            for t in range(sched.ticks):
                m = t - stage
                if sched.real(t, stage):
                    inp = (x[m].detach() if stage == 0 else buf)
                    inp = inp.requires_grad_(stage > 0 or x.requires_grad)
                    y = sched.stage_fn(tree, inp)
                    sched.ins.append(inp)
                    sched.outs.append(y)
                    if stage == last:
                        out[m] = y.detach()
                pairs = sched.forward_pairs(t)
                if pairs:
                    send = y.detach() if (stage, stage + 1) in pairs else None
                    buf = coll.exchange(send, pairs, sched.group, like=mb)
        ctx.sched, ctx.held = sched, held
        ctx.x_grad = x.requires_grad
        ctx.x_meta = (x.shape, x.dtype, x.device)
        if out is None:  # a stage that bears no output: zeros, as the
            out = torch.zeros_like(x)  # reference's masked psum gives
        return out

    @staticmethod
    def backward(ctx, g_out):
        sched, held = ctx.sched, ctx.held
        n, stage, last = sched.n, sched.stage, sched.n - 1
        shape, dtype, device = ctx.x_meta
        gx = (torch.zeros(shape, dtype=dtype, device=device)
              if stage == 0 and ctx.x_grad else None)
        gp: List[Any] = [None] * len(held)
        wants = [p for p in held if p.requires_grad]
        g_in = None
        mb_like = torch.empty(shape[1:], dtype=dtype, device=device)
        for t in reversed(range(sched.ticks)):
            # microbatch t - s's input gradient, computed by stage s + 1
            # in the tick after, goes back to stage s
            pairs = [(s + 1, s) for s in range(n - 1) if sched.real(t, s)]
            recv = None
            if pairs:
                send = g_in if (stage, stage - 1) in pairs else None
                recv = coll.exchange(send, pairs, sched.group, like=mb_like)
            if not sched.real(t, stage):
                continue
            m = t - stage
            gy = g_out[m] if stage == last else recv
            inp, y = sched.ins[m], sched.outs[m]
            need = ([inp] if inp.requires_grad else []) + wants
            got = torch.autograd.grad(y, need, gy, allow_unused=True)
            if inp.requires_grad:
                g_in, got = got[0], got[1:]
                if gx is not None:
                    gx[m] = g_in
            it = iter(got)
            for i, p in enumerate(held):
                if p.requires_grad:
                    g = next(it)
                    if g is not None:
                        gp[i] = g if gp[i] is None else gp[i] + g
            sched.ins[m] = sched.outs[m] = None  # free the graph's ends
        return (None, gx, *gp)


def pipeline_apply(stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
                   stage_params: Any, x: torch.Tensor, mesh,
                   axis: str = "pp", data_axes: tuple = ()) -> torch.Tensor:
    """Run ``x`` through the pp group's stages of ``stage_fn``.

    stage_params : a tree whose leaves have leading dim ``pp`` (stages):
        whole ``[pp, ...]`` stacks, or this rank's placed slices of such
        stacks (``sharding.stage_stack``); ``stage_fn(params, x)`` gets
        this rank's stage (the leading dim removed) and one microbatch,
        and returns an activation of the microbatch's shape.
    x : [n_micro, mb, ...] this rank's rows, microbatched. Only stage 0
        reads it (the others pass any tensor of its shape and dtype).
        ``data_axes`` (the reference's: the rows stay on their dp/fsdp
        shard) needs nothing here: ``x`` already holds this rank's rows.
    Returns [n_micro, mb, ...]: the last stage's outputs on the last
    stage, zeros on the others (the reference broadcasts them with a
    masked psum; a loss here is taken on the last stage).
    """
    group = mesh.group(axis)
    n = group.size
    items = _leaves(stage_params)
    local = [_stage_leaf(p, n, group.rank, axis) for p in items]
    if n <= 1:
        tree = replace_leaves(stage_params, local)
        return torch.stack([stage_fn(tree, x[i]) for i in range(x.shape[0])])
    sched = _Schedule(stage_fn, stage_params, group, x.shape[0])
    return _Pipeline.apply(sched, x, *local)
