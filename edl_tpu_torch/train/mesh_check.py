"""Per-rank programs of the card's mesh check: the functions a
``utils/platform.ProcessPool`` runs on every rank of ``chip_smoke.py``'s
``mesh`` and ``long_context`` phases (:func:`plan_checks`,
:func:`long_context_checks`, :func:`elastic_check`) to train over a dp
x fsdp x tp, sp or pp mesh and bring the result back whole, so it can be
held against one process's step; and the helpers they share with the
tests' rank programs (``tests/torch_pool_cases.py``).

Inputs travel as NumPy: params as a flat dict ``{"layers/wq": array}``
(:func:`flat` / :func:`unflat`), batches as dicts of arrays. Every rank
builds the same whole state, places its slices
(``trainer.shard_state``) and steps; rank 0 returns the gathered
result.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Sequence, Tuple

import numpy as np
import torch

from edl_tpu_torch.utils.tree import leaves, replace_leaves


def flat(tree, prefix: str = "") -> Dict[str, np.ndarray]:
    """{"a/b": array} of a nested dict (or list) of tensors or arrays,
    keyed as the checkpoint keys them."""
    out = {}
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    for k, v in items:
        key = f"{prefix}{k}"
        if isinstance(v, (dict, list)):
            out.update(flat(v, key + "/"))
        elif isinstance(v, torch.Tensor):
            t = v.detach().cpu()
            out[key] = (t.float() if t.dtype == torch.bfloat16
                        else t).numpy().copy()
        else:
            out[key] = np.array(v)
    return out


def unflat(d: Dict[str, Any]) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for k, v in d.items():
        node = out
        parts = k.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return out


def _dtype(name):
    return {"float32": torch.float32, "bfloat16": torch.bfloat16}[name] \
        if isinstance(name, str) else name


def pool_mesh(sizes: Dict[str, int], device: str, ranks=None):
    """(plan, mesh, pool group) of this rank for the plan ``sizes``."""
    import torch.distributed as dist

    from edl_tpu_torch.parallel.collectives import Group
    from edl_tpu_torch.parallel.mesh import MeshPlan

    dev = torch.device("cpu") if device == "cpu" else torch.device(
        "cuda", torch.cuda.current_device())
    plan = MeshPlan.create(**sizes)
    mesh = plan.build([dev], ranks=ranks)
    pool = Group(None, dist.get_world_size(), dist.get_rank())
    return plan, mesh, pool


def _with_info(g: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    from edl_tpu_torch.parallel import sharding as shd

    g = g.detach()
    inf = shd.info(p)
    return shd.attach(g, inf) if inf is not None else g


# -- the card's mesh phase (chip_smoke.py), one program a rank ----------------


def _device(device: str) -> torch.device:
    return torch.device("cpu") if device == "cpu" else torch.device(
        "cuda", torch.cuda.current_device())


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _llama_cfg(cfg_kw: dict):
    from edl_tpu_torch.models import llama

    return llama.LlamaConfig(**{**cfg_kw, "dtype": _dtype(
        cfg_kw.get("dtype", "bfloat16"))})


def _init(cfg, seed: int, dev: torch.device):
    """The whole f32 params from ``seed``: the same bits on every rank
    (one generator, one device kind)."""
    from edl_tpu_torch.models import llama

    return llama.init_params(cfg, seed=seed, device=dev, dtype=torch.float32)


def grad_cfg(cfg):
    """The config the mesh phase's gradients are compared in: ``cfg`` in
    f32 with the dense attention (the flash kernels are bf16 only), so
    the one-rank and the sharded gradients are the same math and differ
    only in the order of the collectives' sums (bf16 rounding alone
    moves wq's by ~2e-2 relative L2 at init)."""
    return dataclasses.replace(cfg, dtype=torch.float32, use_flash=False)


def _rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def plan_checks(cfg_kw: dict, batches: Sequence[Dict[str, np.ndarray]],
                plans: Sequence[Dict[str, int]], lr: float = 1e-3,
                seed: int = 0, device: str = "cuda") -> Dict[str, Any]:
    """Part (a) of the mesh phase, on every rank of the pool: rank 0
    first takes the one-rank steps (``adamw``, ``make_train_step`` with
    no mesh) from the params of ``seed`` over ``batches``, and the
    one-rank loss and gradients of the first batch in f32 with the dense
    attention (``grad_cfg``), kept on the host; then, for each plan of
    ``plans``, every rank places the same params on the plan's mesh,
    takes the sharded loss and gradients of the first batch in that f32
    dense config (gathered whole to rank 0 and held to the one-rank ones
    leaf by leaf, relative L2: the same math in f32, so only the
    collectives' summation order differs) and the sharded steps of the
    model's own config (bf16, flash) over ``batches``. Each rank
    returns, by plan: its losses, step seconds, collective stats (over
    the steps), peak device bytes and flash launches (of the steps);
    rank 0 also the one-rank losses and, by plan, each leaf's gradient
    error and the f32 loss pair."""
    import torch.distributed as dist

    from edl_tpu_torch.models import llama
    from edl_tpu_torch.ops import flash_attention as fa
    from edl_tpu_torch.parallel import collectives as coll
    from edl_tpu_torch.train import trainer

    cfg = _llama_cfg(cfg_kw)
    g_cfg = grad_cfg(cfg)
    dev = _device(device)
    rank = dist.get_rank()
    out: Dict[str, Any] = {"rank": rank, "plans": {}}
    ref_grads = ref_loss = None
    if rank == 0:
        tx = trainer.adamw(lr)
        st = trainer.TrainState.create(_init(cfg, seed, dev), tx)
        b0 = trainer.global_batch(batches[0], device=dev)
        loss, g = trainer.value_and_grad(llama.make_loss_fn(g_cfg))(
            st.params, b0)
        ref_loss, ref_grads = float(loss), flat(g)
        del g
        step = trainer.make_train_step(llama.make_loss_fn(cfg), tx)
        losses, secs = [], []
        for b in batches:
            t = time.perf_counter()
            st, m = step(st, trainer.global_batch(b, device=dev))
            losses.append(float(m["loss"]))
            secs.append(time.perf_counter() - t)
        out["one_rank"] = {"losses": losses, "step_s": secs}
        del st, step, b0
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    dist.barrier()
    for sizes in plans:
        name = "x".join(f"{a}{n}" for a, n in sizes.items())
        plan, mesh, pool = pool_mesh(sizes, device)
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        tx = trainer.adamw(lr)
        state = trainer.shard_state(
            trainer.TrainState.create(_init(cfg, seed, dev), tx), plan,
            mesh, param_pspecs=llama.param_pspecs(cfg, plan))
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        t = time.perf_counter()
        g_loss, g, _ = trainer.sharded_value_and_grad(
            llama.make_loss_fn(g_cfg, plan, mesh), state.params,
            trainer.global_batch(batches[0], plan, mesh), mesh)
        _sync(dev)
        grad_s = time.perf_counter() - t
        gp = replace_leaves(state.params, [
            _with_info(x, p) for x, p in zip(g, leaves(state.params))])
        del g
        gw = trainer.gather_state(trainer.TrainState(
            step=0, params=gp, opt_state=torch.optim.SGD(leaves(gp), lr=0)),
            mesh, pool)
        del gp
        grad_err = grad_loss = None
        if gw is not None:
            got = flat(gw.params)
            grad_err = {k: _rel_l2(torch.from_numpy(got[k]),
                                   torch.from_numpy(ref_grads[k]))
                        for k in ref_grads}
            grad_loss = (float(g_loss), ref_loss)
            del got
        del gw
        loss_fn = llama.make_loss_fn(cfg, plan, mesh)
        fa.reset_launches()
        step = trainer.make_train_step(loss_fn, tx, plan, mesh)
        coll.reset_stats()
        losses, secs, reduce_s = [], [], []
        for b in batches:
            t = time.perf_counter()
            state, m = step(state, trainer.global_batch(b, plan, mesh))
            losses.append(float(m["loss"]))
            secs.append(time.perf_counter() - t)
            reduce_s.append(float(m["allreduce_s"]))
        stats = coll.stats()
        launches = fa.launch_counts()
        peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
                else 0)
        out["plans"][name] = {
            "losses": losses, "step_s": secs, "grad_s": grad_s,
            "grad_reduce_s": reduce_s, "collectives": stats,
            "peak_bytes": int(peak), "launches": launches,
            "grad_rel_l2": grad_err, "grad_loss": grad_loss}
        del state, step, loss_fn
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        dist.barrier()
    return out


def long_context_checks(cfg_kw: dict, plans: Sequence[Dict[str, Any]],
                        lr: float = 1e-3, seed: int = 0,
                        device: str = "cuda") -> Dict[str, Any]:
    """Parts (a)-(c) of chip_smoke's long_context phase, on every rank of
    the pool: for each plan of ``plans`` ({"name", "sizes": the mesh,
    "cfg": overrides of ``cfg_kw`` such as ``sp_impl`` or
    ``pp_microbatches``, "batch", "seq", "grad_seq": the f32 pass's
    length, "steps"}), rank 0 first takes the one-rank loss and
    gradients of the f32 dense-attention config (``grad_cfg``) on the
    plan's first batch cut to ``grad_seq`` positions, and the one-rank
    loss of the model's own config (bf16, flash) on the first whole
    batch; then every rank places the params of ``seed`` on the plan's
    mesh, takes the sharded f32 pass (gradients gathered whole to rank 0
    and held to the one-rank ones leaf by leaf, relative L2) and the
    plan's bf16 steps. Each rank returns, by plan: its losses, step
    seconds, collective stats (over the steps), peak device bytes and
    flash launches (of the steps); rank 0 also each leaf's gradient
    error, the f32 loss pair and the one-rank bf16 first loss."""
    import torch.distributed as dist

    from edl_tpu_torch.models import llama
    from edl_tpu_torch.ops import flash_attention as fa
    from edl_tpu_torch.parallel import collectives as coll
    from edl_tpu_torch.train import trainer

    dev = _device(device)
    rank = dist.get_rank()
    out: Dict[str, Any] = {"rank": rank, "plans": {}}
    for pc in plans:
        cfg = _llama_cfg({**cfg_kw, **pc.get("cfg", {})})
        g_cfg = grad_cfg(cfg)
        rng = np.random.RandomState(seed)
        batches = [llama.synthetic_tokens(rng, pc["batch"], pc["seq"],
                                          cfg.vocab)
                   for _ in range(pc["steps"])]
        g_batch = {"tokens": batches[0]["tokens"][:, :pc["grad_seq"] + 1]}
        ref_grads = ref_loss = one_first = None
        if rank == 0:
            params = _init(cfg, seed, dev)
            for p in leaves(params):
                p.requires_grad_(True)
            loss, g = trainer.value_and_grad(llama.make_loss_fn(g_cfg))(
                params, trainer.global_batch(g_batch, device=dev))
            ref_loss, ref_grads = float(loss), flat(g)
            del g
            with torch.no_grad():
                one_first = float(llama.make_loss_fn(cfg)(
                    params, trainer.global_batch(batches[0], device=dev)))
            del params
            if dev.type == "cuda":
                torch.cuda.empty_cache()
        dist.barrier()
        plan, mesh, pool = pool_mesh(pc["sizes"], device)
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        tx = trainer.adamw(lr)
        state = trainer.shard_state(
            trainer.TrainState.create(_init(cfg, seed, dev), tx), plan,
            mesh, param_pspecs=llama.param_pspecs(cfg, plan))
        t = time.perf_counter()
        g_loss, g, _ = trainer.sharded_value_and_grad(
            llama.make_loss_fn(g_cfg, plan, mesh), state.params,
            trainer.global_batch(g_batch, plan, mesh), mesh)
        _sync(dev)
        grad_s = time.perf_counter() - t
        gp = replace_leaves(state.params, [
            _with_info(x, p) for x, p in zip(g, leaves(state.params))])
        del g
        gw = trainer.gather_state(trainer.TrainState(
            step=0, params=gp, opt_state=torch.optim.SGD(leaves(gp), lr=0)),
            mesh, pool)
        del gp
        grad_err = None
        if gw is not None:
            got = flat(gw.params)
            grad_err = {k: _rel_l2(torch.from_numpy(got[k]),
                                   torch.from_numpy(ref_grads[k]))
                        for k in ref_grads}
            del got
        del gw
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        fa.reset_launches()
        step = trainer.make_train_step(llama.make_loss_fn(cfg, plan, mesh),
                                       tx, plan, mesh)
        coll.reset_stats()
        losses, secs = [], []
        for b in batches:
            t = time.perf_counter()
            state, m = step(state, trainer.global_batch(b, plan, mesh))
            losses.append(float(m["loss"]))
            secs.append(time.perf_counter() - t)
        out["plans"][pc["name"]] = {
            "losses": losses, "step_s": secs, "grad_s": grad_s,
            "collectives": coll.stats(),
            "peak_bytes": int(torch.cuda.max_memory_allocated(dev)
                              if dev.type == "cuda" else 0),
            "launches": fa.launch_counts(), "grad_rel_l2": grad_err,
            "grad_loss": (float(g_loss), ref_loss) if rank == 0 else None,
            "one_rank_first_loss": one_first}
        del state, step
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        dist.barrier()
    return out


def _digest(state, keys: Sequence[str], pool) -> List[int]:
    """Two position-keyed sums over every element's bits of each leaf
    ``keys`` (``checkpoint``'s ``p:``/``o:`` names) of a placed state,
    counted once a leaf (replica 0 of each slice) and summed over the
    pool: equal before and after a move iff the whole state's bits
    are, short of a collision of two 32-bit mixes. Integer sums, so
    exact in any order."""
    from edl_tpu_torch.parallel import collectives as coll
    from edl_tpu_torch.runtime import checkpoint as ckpt

    vals = {k: (0, 0) for k in keys}
    if state is not None:
        items = ckpt._state_leaf_items(state)
        for (key, t), inf in zip(items, ckpt._leaf_layouts(state)):
            if inf is not None and not ckpt._replica0(inf):
                continue
            shape = inf.shape if inf is not None else tuple(t.shape)
            off = inf.box()[0] if inf is not None else (0,) * len(shape)
            dev = t.device
            gidx = torch.zeros((), dtype=torch.int64, device=dev)
            stride = 1
            for d in reversed(range(len(shape))):
                ar = torch.arange(t.shape[d], device=dev,
                                  dtype=torch.int64) + off[d]
                view = [1] * len(shape)
                view[d] = t.shape[d]
                gidx = gidx + ar.view(view) * stride
                stride *= shape[d]
            t = t.detach().contiguous()
            if t.element_size() != 4:
                t = t.float()
            bits = t.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
            g = gidx & 0x7FFFFFFF
            h1 = ((bits ^ ((g * 0x5BD1E995) & 0xFFFFFFFF)) * 40503) \
                & 0xFFFFFFFF
            h2 = ((bits ^ ((g * 0x27D4EB2F) & 0xFFFFFFFF)) * 52711) \
                & 0xFFFFFFFF
            vals[key] = (int(h1.sum()), int(h2.sum()))
    v = torch.tensor([x for k in keys for x in vals[k]], dtype=torch.int64)
    coll.all_reduce(v, pool)
    return v.tolist()


class _Recorded:
    """A data_fn that remembers its last batch."""

    def __init__(self, cfg, seed: int, seq: int):
        from edl_tpu_torch.models import llama

        self.rng = np.random.RandomState(seed)
        self.seq, self.vocab = seq, cfg.vocab
        self.tokens = llama.synthetic_tokens
        self.last = None

    def __call__(self, batch_size: int):
        self.last = self.tokens(self.rng, batch_size, self.seq, self.vocab)
        return self.last


def elastic_check(cfg_kw: dict, schedule: Sequence[Tuple[int, int]],
                  seq: int = 2048, lr: float = 1e-3, seed: int = 0,
                  device: str = "cuda", spec=None) -> Dict[str, Any]:
    """Part (b) of the mesh phase (and (d) of the long_context phase),
    on every rank of the pool: an ``ElasticTrainer(mesh_spec=
    MeshSpec(**spec), chips_per_worker=2, per_chip_batch=1)`` (``spec``
    default ``{"tp": 2}``) on the llama of ``cfg_kw`` (adamw, the mesh
    loss), through ``schedule`` [(workers, steps)]: start at the first
    count, then rescale before each next entry. At each rescale every
    rank takes part in: the state's digests before and after
    (:func:`_digest`), and the params gathered whole onto rank 0 before
    it, whose one-rank loss on the first batch after the rescale rank 0
    holds to the trainer's first loss there. Returns rank 0's events,
    losses, steps, digests, those loss pairs and every rank's flash
    launches (the one-rank checks' launches excluded)."""
    import torch.distributed as dist

    from edl_tpu_torch.api.job import MeshSpec
    from edl_tpu_torch.models import llama
    from edl_tpu_torch.ops import flash_attention as fa
    from edl_tpu_torch.runtime import checkpoint as ckpt
    from edl_tpu_torch.runtime.elastic import ElasticTrainer
    from edl_tpu_torch.train import trainer

    cfg = _llama_cfg(cfg_kw)
    dev = _device(device)
    rank = dist.get_rank()
    tr = ElasticTrainer(
        None, trainer.adamw(lr),
        mesh_spec=MeshSpec(**(spec or {"tp": 2})),
        chips_per_worker=2, per_chip_batch=1,
        param_pspecs=lambda plan: llama.param_pspecs(cfg, plan),
        make_loss=lambda plan, mesh: llama.make_loss_fn(cfg, plan, mesh),
        device=dev)
    tr.start(_init(cfg, seed, dev), schedule[0][0])
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    data = _Recorded(cfg, seed, seq)
    keys = None
    if rank == 0:
        keys = sorted(k for k, _ in ckpt._state_leaf_items(tr.state))
    keys = _bcast(keys)
    steps_seen, digests, firsts = [], [], []
    fa.reset_launches()
    counted = {k: 0 for k in fa.KERNELS}
    for i, (n, steps) in enumerate(schedule):
        if i:
            before = _digest(tr.state, keys, tr.pool_group)
            pre_params = gather_params(tr.state, tr.mesh, tr.pool_group,
                                       dev)
            tr.request_rescale(n)
            tr._maybe_rescale()
            after = _digest(tr.state, keys, tr.pool_group)
            digests.append((before, after))
            tr.train_steps(data, 1)
            steps_seen.append(None if tr.state is None else
                              int(tr.state.step))
            if pre_params is not None:
                for k, v in fa.launch_counts().items():
                    counted[k] += v
                with torch.no_grad():
                    one = float(llama.make_loss_fn(cfg)(
                        pre_params, trainer.global_batch(data.last,
                                                         device=dev)))
                fa.reset_launches()
                firsts.append((tr.report.losses[-1], one))
            del pre_params
            if dev.type == "cuda":
                torch.cuda.empty_cache()
            steps -= 1
        tr.train_steps(data, steps)
        steps_seen.append(None if tr.state is None else int(tr.state.step))
    for k, v in fa.launch_counts().items():
        counted[k] += v
    return {"rank": rank, "launches": counted,
            "events": [dict(from_workers=e.from_workers,
                            to_workers=e.to_workers, stall_s=e.stall_s,
                            recompile_s=e.recompile_s, step=e.step,
                            fallback=e.fallback)
                       for e in tr.report.reshards],
            "losses": tr.report.losses, "steps": tr.report.steps,
            "state_steps": steps_seen, "digests": digests,
            "first_losses": firsts, "plans": tr.plan.describe()}


def gather_params(state, mesh, pool, device):
    """The params alone gathered whole onto the mesh's first rank (on
    ``device``), None elsewhere: every process of ``pool`` calls it."""
    from edl_tpu_torch.train import trainer

    only = None
    if state is not None:
        only = trainer.TrainState(step=state.step, params=state.params,
                                  opt_state=torch.optim.SGD(
                                      leaves(state.params), lr=0))
    whole = trainer.gather_state(only, mesh, pool, device=device)
    return None if whole is None else whole.params


def _bcast(obj):
    import torch.distributed as dist

    box = [obj]
    dist.broadcast_object_list(box, 0)
    return box[0]
