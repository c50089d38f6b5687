"""Per-rank programs of the port's pool tests (``tests/test_torch_mesh*.py``):
top-level functions a ``utils/platform.ProcessPool`` rank runs. No jax:
a pool rank imports only the port."""

from __future__ import annotations

import numpy as np
import torch

from edl_tpu_torch.api.job import MeshSpec
from edl_tpu_torch.models import ctr, linreg
from edl_tpu_torch.models.convert import params_from_numpy
from edl_tpu_torch.parallel import sharding as shd
from edl_tpu_torch.runtime import checkpoint as ckpt
from edl_tpu_torch.runtime import elastic as el
from edl_tpu_torch.train import mesh_check, trainer


def _optimizer(name: str, lr: float):
    return {"adamw": trainer.adamw, "adam": trainer.adam,
            "adafactor": trainer.adafactor, "sgd": trainer.sgd}[name](lr)


def _loss_and_specs(model: str, cfg_kw, plan, mesh):
    if model == "llama":
        from edl_tpu_torch.models import llama

        cfg = llama.LlamaConfig(**{**cfg_kw, "dtype": torch.float32})
        return (llama.make_loss_fn(cfg, plan, mesh),
                llama.param_pspecs(cfg, plan))
    if model == "linreg":
        return linreg.loss_fn, None
    return ctr.make_loss_fn(), None


def mesh_steps(model, params_np, batches, sizes, opt="adamw", lr=1e-3,
               cfg_kw=None, grads=False):
    """Train ``model`` ("llama" in f32, "linreg" or "ctr") on the CPU
    from ``params_np`` over the mesh ``sizes`` of the pool's first
    ranks, one step a batch of ``batches`` (whole global batches). Rank
    0 returns {"losses", "params" (flat, whole), "step_s", "grads" (flat,
    whole, of the first batch, when ``grads``), "collectives" (this
    rank's ``collectives.stats``)}; every rank its losses."""
    import time

    from edl_tpu_torch.parallel import collectives as coll
    from edl_tpu_torch.utils.tree import leaves, replace_leaves

    plan, mesh, pool = mesh_check.pool_mesh(sizes, "cpu")
    loss_fn, pspecs = _loss_and_specs(model, cfg_kw, plan, mesh)
    tx = _optimizer(opt, lr)
    state = None
    if mesh.member:
        whole = params_from_numpy(mesh_check.unflat(params_np),
                                  device=mesh.device)
        state = trainer.shard_state(trainer.TrainState.create(whole, tx),
                                    plan, mesh, param_pspecs=pspecs)
    coll.reset_stats()
    g_whole = None
    if grads:
        g_state = None
        if mesh.member:
            b = trainer.global_batch(batches[0], plan, mesh)
            _, g, _ = trainer.sharded_value_and_grad(loss_fn, state.params,
                                                     b, mesh)
            gp = replace_leaves(state.params, [
                mesh_check._with_info(x, p)
                for x, p in zip(g, leaves(state.params))])
            g_state = trainer.TrainState(
                step=0, params=gp,
                opt_state=torch.optim.SGD(leaves(gp), lr=0))
        g_whole = trainer.gather_state(g_state, mesh, pool)
    step = trainer.make_train_step(loss_fn, tx, plan, mesh)
    losses, step_s = [], []
    for b in batches:
        if mesh.member:
            t = time.perf_counter()
            state, m = step(state, trainer.global_batch(b, plan, mesh))
            losses.append(float(m["loss"]))
            step_s.append(time.perf_counter() - t)
    stats = coll.stats()
    whole = trainer.gather_state(state, mesh, pool)
    out = {"losses": losses, "step_s": step_s, "collectives": stats}
    if whole is None:
        return out
    out["params"] = mesh_check.flat(whole.params)
    if g_whole is not None:
        out["grads"] = mesh_check.flat(g_whole.params)
    return out


def linreg_data_fn():
    x, y = linreg.synthetic_dataset(4096)
    state = {"i": 0}

    def fn(batch_size):
        lo = state["i"] % (4096 - batch_size)
        state["i"] += batch_size
        return {"x": x[lo: lo + batch_size], "y": y[lo: lo + batch_size]}

    return fn


def whole(tr):
    """The trainer's state gathered whole on the pool's first rank
    (flat numpy params and optimizer tensors), None elsewhere."""
    st = tr._whole_state()
    if st is None:
        return None
    ps = trainer.leaves(st.params)
    return {"params": mesh_check.flat(st.params),
            "opt": {f"{i}/{name}": t.detach().cpu().numpy().copy()
                    for i, name, t, _ in trainer.optimizer_tensors(st)},
            "step": int(st.step), "n": len(ps)}


class _FailOnce:
    """``trainer.reshard_plans`` that raises ``kind`` on its next call
    and is itself after: armed just before a rescale, it fails the
    device path's local part on this rank alone (the host path's own
    call, after it, runs)."""

    def __init__(self, kind):
        self.kind, self.armed = kind, False
        self.real = trainer.reshard_plans

    def __call__(self, *a, **k):
        if self.armed:
            self.armed = False
            raise self.kind("CUDA out of memory (planted on one rank)")
        return self.real(*a, **k)


def elastic_linreg(params_np, schedule, opt="sgd", lr=0.05,
                   chips_per_worker=1, per_chip_batch=16, spec=None,
                   fail_device=False, fail_kind=RuntimeError):
    """An ``ElasticTrainer`` on linreg through ``schedule``: [(workers,
    steps)] — start at the first count, then rescale before each next
    entry. Returns rank 0's losses, events, steps and the whole state
    before and after each rescale. ``fail_device``: True makes the
    device path raise on every rank; a rank number makes the device
    path's local part raise ``fail_kind`` on that rank alone, at each
    rescale."""
    tx = {"sgd": trainer.sgd, "adam": trainer.adam}[opt](lr)
    tr = el.ElasticTrainer(linreg.loss_fn, tx, mesh_spec=spec or MeshSpec(),
                           chips_per_worker=chips_per_worker,
                           per_chip_batch=per_chip_batch, device="cpu")
    one = None
    if fail_device is True:
        def _boom(*a, **k):
            raise RuntimeError("transfer layer down")

        el._device_reshard, keep = _boom, el._device_reshard
    elif fail_device is not False and torch.distributed.get_rank() == \
            fail_device:
        one = trainer.reshard_plans = _FailOnce(fail_kind)
    try:
        data = linreg_data_fn()
        tr.start(params_from_numpy(params_np, device="cpu"), schedule[0][0])
        snaps = []
        for i, (n, steps) in enumerate(schedule):
            if i:
                snaps.append(whole(tr))
                tr.request_rescale(n)
                if one is not None:
                    one.armed = True
                tr._maybe_rescale()
                snaps.append(whole(tr))
            tr.train_steps(data, steps)
    finally:
        if fail_device is True:
            el._device_reshard = keep
        if one is not None:
            trainer.reshard_plans = one.real
    return {"losses": tr.report.losses,
            "events": [(e.from_workers, e.to_workers, e.step, e.fallback,
                        e.stall_s) for e in tr.report.reshards],
            "steps": tr.report.steps, "n_devices": tr.n_devices,
            "batch": tr.global_batch_size, "snaps": snaps,
            "final": whole(tr), "member": tr.member,
            "state_step": None if tr.state is None else int(tr.state.step)}


def elastic_ctr_fsdp(params_np, vocab=4096, steps=5):
    """The fsdp CTR job: 2 workers x 2 chips on MeshSpec(fsdp=2), then 4
    workers... on a pool of 4 ranks: 1 worker x 2 chips (fsdp 2), then
    2 workers (dp 2 x fsdp 2). Returns each phase's embedding slice
    shape on this rank and rank 0's losses and plans."""
    tr = el.ElasticTrainer(ctr.loss_fn, trainer.adam(1e-2),
                           mesh_spec=MeshSpec(fsdp=2), chips_per_worker=2,
                           per_chip_batch=32, device="cpu")
    rng = np.random.RandomState(0)

    def data(bs):
        return ctr.synthetic_batch(rng, bs, vocab=vocab)

    tr.start(params_from_numpy(params_np, device="cpu"), 1)
    tr.train_steps(data, steps)
    shape0 = None if tr.state is None else \
        tuple(tr.state.params["embedding"].shape)
    plan0 = tr.plan.describe()
    tr.request_rescale(2)
    tr.train_steps(data, steps)
    shape1 = tuple(tr.state.params["embedding"].shape)
    return {"shapes": (shape0, shape1), "plans": (plan0, tr.plan.describe()),
            "losses": tr.report.losses,
            "stall": tr.report.reshards[0].stall_s,
            "final": whole(tr)}


def _ctr_state(params_np, sizes, vocab, steps=1, seed=0, opt="adam"):
    """A CTR state placed on the mesh ``sizes`` after ``steps`` Adam
    steps (so the moments exist); (plan, mesh, pool, state)."""
    plan, mesh, pool = mesh_check.pool_mesh(sizes, "cpu")
    tx = trainer.adam(1e-3)
    state = None
    if mesh.member:
        whole = ctr_params(params_np)
        state = trainer.shard_state(trainer.TrainState.create(whole, tx),
                                    plan, mesh)
        step = trainer.make_train_step(ctr.loss_fn, tx, plan, mesh)
        rng = np.random.RandomState(seed)
        for _ in range(steps):
            b = ctr.synthetic_batch(rng, 64, vocab=vocab)
            state, _ = step(state, trainer.global_batch(b, plan, mesh))
    return plan, mesh, pool, state


def ctr_params(params_np):
    from edl_tpu_torch.models.convert import ctr_params_from_numpy

    return ctr_params_from_numpy(params_np, device="cpu")


def _flat_state(st):
    if st is None:
        return None
    return {"params": mesh_check.flat(st.params),
            "opt": {f"{i}/{name}": t.detach().cpu().numpy().copy()
                    for i, name, t, _ in trainer.optimizer_tensors(st)},
            "step": int(st.step)}


def staged_vs_restore(params_np, vocab, src, dst, chunk_bytes, stage):
    """A CTR state on mesh ``src`` moved onto mesh ``dst`` (of the pool's
    first ranks) by ``staged_reshard`` and by ``restore(snapshot)``;
    rank 0 returns both gathered whole, the source gathered whole, and
    the local embedding slice shapes of each rank."""
    from edl_tpu_torch.parallel.mesh import MeshPlan

    keep = shd._CHUNK_BYTES
    shd._CHUNK_BYTES = chunk_bytes
    try:
        splan, smesh, pool, state = _ctr_state(params_np, src, vocab)
        before = trainer.gather_state(state, smesh, pool)
        dplan = MeshPlan.create(**dst)
        dmesh = dplan.build([torch.device("cpu")])
        out = ckpt.staged_reshard(state, dplan, dmesh, stage=stage,
                                  pool=pool, src_mesh=smesh)
        snap = ckpt.snapshot(state) if state is not None else None
        ref = ckpt.restore(snap, dplan, dmesh, pool=pool, src_mesh=smesh)
        shapes = None if out is None else \
            tuple(out.params["embedding"].shape)
        a = trainer.gather_state(out, dmesh, pool)
        b = trainer.gather_state(ref, dmesh, pool)
    finally:
        shd._CHUNK_BYTES = keep
    return {"staged": _flat_state(a), "restored": _flat_state(b),
            "before": _flat_state(before), "shape": shapes,
            "step": None if out is None else int(out.step)}


def checkpoint_roundtrip(params_np, root, cfg_kw, src, dst):
    """A llama tiny state on mesh ``src`` after one AdamW step, written
    as sliced pieces (``snapshot_local`` + ``save_shards`` on every rank,
    the manifest by rank 0), then loaded onto mesh ``dst``
    (``load_sharded``: each member reads its slices) and whole on rank
    0. Rank 0 returns the source, the re-loaded state (gathered) and the
    whole load; each rank its pieces' offsets and primaries."""
    import torch.distributed as dist

    from edl_tpu_torch.models import llama
    from edl_tpu_torch.parallel.mesh import MeshPlan

    cfg = llama.LlamaConfig(**{**cfg_kw, "dtype": torch.float32})
    tx = trainer.adamw(1e-3)
    splan, smesh, pool = mesh_check.pool_mesh(src, "cpu")
    whole = mesh_check.unflat({k: torch.tensor(v)
                               for k, v in params_np.items()})
    state = trainer.shard_state(trainer.TrainState.create(whole, tx),
                                splan, smesh,
                                param_pspecs=llama.param_pspecs(cfg, splan))
    step = trainer.make_train_step(llama.make_loss_fn(cfg, splan, smesh), tx,
                                   splan, smesh)
    b = llama.synthetic_tokens(np.random.RandomState(0), 4, 16, cfg.vocab)
    state, _ = step(state, trainer.global_batch(b, splan, smesh))
    snap = ckpt.snapshot_local(state)
    rank, world = dist.get_rank(), dist.get_world_size()
    fname = ckpt.save_shards(root, snap, rank, world)
    files = [None] * world
    dist.all_gather_object(files, fname)
    if rank == 0:
        ckpt.write_manifest(root, snap, files)
    dist.barrier()
    dplan = MeshPlan.create(**dst)
    dmesh = dplan.build([torch.device("cpu")])
    loaded = ckpt.load_sharded(root, tx, device="cpu", plan=dplan,
                               mesh=dmesh,
                               param_pspecs=llama.param_pspecs(cfg, dplan))
    local_shape = None if loaded is None else \
        tuple(loaded.params["layers"]["wq"].shape)
    src_whole = trainer.gather_state(state, smesh, pool)
    got = trainer.gather_state(loaded, dmesh, pool)
    flat_whole = None
    if rank == 0:
        flat_whole = _flat_state(ckpt.load_sharded(root, tx, device="cpu"))
    return {"src": _flat_state(src_whole), "loaded": _flat_state(got),
            "whole": flat_whole, "local_wq": local_shape,
            "primary": {k: v for k, v in snap.primary.items()},
            "offsets": {k: [o for o, _ in v] for k, v in snap.pieces.items()}}


def remat_and_multistep(params_np, cfg_kw, batches, sizes):
    """On the mesh ``sizes``: the llama loss under each remat policy
    (the first batch, one value_and_grad each; "attn" keeps each tp
    rank's flash outputs), and ``make_train_multistep`` over
    ``stack_batches`` against as many ``make_train_step`` calls. Rank 0
    returns the losses by policy, the grads' max difference from no
    remat, and both step paths' losses and gathered params."""
    import dataclasses

    from edl_tpu_torch.models import llama

    cfg = llama.LlamaConfig(**{**cfg_kw, "dtype": torch.float32})
    plan, mesh, pool = mesh_check.pool_mesh(sizes, "cpu")
    whole = mesh_check.unflat({k: torch.tensor(v)
                               for k, v in params_np.items()})
    out = {"loss": {}, "grad_diff": {}}
    b0 = trainer.global_batch(batches[0], plan, mesh)
    ref_g = None
    for policy in (None, "full", "attn", "mlp", "dots"):
        c = cfg if policy is None else dataclasses.replace(
            cfg, remat=True, remat_policy=policy)
        tx = trainer.adamw(1e-3)
        st = trainer.shard_state(trainer.TrainState.create(whole, tx), plan,
                                 mesh, param_pspecs=llama.param_pspecs(c,
                                                                       plan))
        loss, g, _ = trainer.sharded_value_and_grad(
            llama.make_loss_fn(c, plan, mesh), st.params, b0, mesh)
        out["loss"][str(policy)] = float(loss)
        if ref_g is None:
            ref_g = g
        else:
            out["grad_diff"][str(policy)] = max(
                float((a - b).abs().max()) for a, b in zip(g, ref_g))
    runs = {}
    for kind in ("step", "multistep"):
        tx = trainer.adamw(1e-3)
        st = trainer.shard_state(trainer.TrainState.create(whole, tx), plan,
                                 mesh, param_pspecs=llama.param_pspecs(cfg,
                                                                       plan))
        loss_fn = llama.make_loss_fn(cfg, plan, mesh)
        if kind == "step":
            step = trainer.make_train_step(loss_fn, tx, plan, mesh)
            losses = []
            for b in batches:
                st, m = step(st, trainer.global_batch(b, plan, mesh))
                losses.append(float(m["loss"]))
        else:
            multi = trainer.make_train_multistep(loss_fn, tx, plan, mesh)
            st, m = multi(st, trainer.stack_batches(batches, plan, mesh))
            losses = [float(x) for x in m["losses"]]
        w = trainer.gather_state(st, mesh, pool)
        runs[kind] = {"losses": losses,
                      "params": None if w is None else mesh_check.flat(
                          w.params)}
    out["runs"] = runs
    return out


def elastic_checkpoint_resume(params_np, root, vocab=2048):
    """fsdp CTR on 2 workers of 2 chips with a checkpoint every 3 steps;
    a second trainer resumes the step-3 checkpoint on 1 worker. Rank 0
    returns the path written, the resumed step and both whole states
    at step 3 (the first trainer's gathered before its 4th step)."""
    tx = trainer.adam(1e-2)
    rng = np.random.RandomState(0)

    def data(bs):
        return ctr.synthetic_batch(rng, bs, vocab=vocab)

    tr = el.ElasticTrainer(ctr.loss_fn, tx, mesh_spec=MeshSpec(fsdp=2),
                           chips_per_worker=2, per_chip_batch=16,
                           device="cpu", checkpoint_dir=root,
                           checkpoint_every_steps=3)
    tr.start(params_from_numpy(params_np, device="cpu"), 2)
    tr.train_steps(data, 3)
    at3 = _flat_state(tr._whole_state())
    tr2 = el.ElasticTrainer(ctr.loss_fn, tx, mesh_spec=MeshSpec(fsdp=2),
                            chips_per_worker=2, per_chip_batch=16,
                            device="cpu")
    import os

    path = os.path.join(root, "step-3")
    tr2.resume(params_from_numpy(params_np, device="cpu"), 1, path)
    return {"written": os.path.exists(os.path.join(path, "state.npz")),
            "step": tr2._host_step, "at3": at3,
            "resumed": _flat_state(tr2._whole_state()),
            "shape": None if tr2.state is None else
            tuple(tr2.state.params["embedding"].shape)}


# -- sequence and pipeline parallelism (tests/test_torch_sp_pp.py) ----------


def _batch_part(x, plan, mesh):
    """This member's rows of ``x`` (the batch split over the batch
    axes, as ``trainer.global_batch``)."""
    return trainer.global_batch({"x": x}, plan, mesh, device="cpu")["x"]


def _row_span(plan, mesh, rows):
    """(first, end) of this member's rows of a batch of ``rows``."""
    c, idx = mesh.coords(), 0
    for a in plan.batch_axes():
        idx = idx * plan.axis_size(a) + c[a]
    n = rows // plan.batch_shards()
    return idx * n, (idx + 1) * n


def seq_attention(impl, q, k, v, sizes, causal=True):
    """``impl`` ("ring" or "ulysses") on the mesh ``sizes`` over this
    rank's rows and sequence part of q/k/v [B, T, H, d]; returns this
    rank's output, its q gradient under ``sum(out * w)`` for a fixed
    weight, and its place (batch rows, first position)."""
    from edl_tpu_torch.parallel.ring_attention import ring_attention
    from edl_tpu_torch.parallel.ulysses import ulysses_attention

    plan, mesh, _ = mesh_check.pool_mesh(sizes, "cpu")
    if not mesh.member:
        return None
    parts = []
    for x in (q, k, v):
        rows = _batch_part(x, plan, mesh)
        part, pos0 = shd.sequence_part(rows, mesh)
        parts.append(part.clone().requires_grad_(True))
    fn = ring_attention if impl == "ring" else ulysses_attention
    out = fn(*parts, mesh, axis="sp", causal=causal)
    w = torch.linspace(-1.0, 1.0, out.numel()).reshape(out.shape)
    (out * w).sum().backward()
    return {"out": out.detach().numpy(), "dq": parts[0].grad.numpy(),
            "rows": _row_span(plan, mesh, q.shape[0]), "pos0": pos0}


def pipeline_case(params_np, x, sizes, loss=True):
    """``pipeline_apply`` of ``tanh(x @ w + b)`` stages over the mesh
    ``sizes`` (the pp group this rank's, the microbatch rows its batch
    shard's: x [n_micro, mb, d] split on mb); returns the output on the
    last stage and, with ``loss``, this stage's gradients of the mean
    of out² over the global batch (the loss on the last stage)."""
    from edl_tpu_torch.parallel.pipeline import pipeline_apply

    plan, mesh, _ = mesh_check.pool_mesh(sizes, "cpu")
    if not mesh.member:
        return None
    params = {k: torch.tensor(v, requires_grad=True)
              for k, v in params_np.items()}
    xt = torch.tensor(x)
    r0, r1 = _row_span(plan, mesh, xt.shape[1])
    xl = xt[:, r0:r1]

    def stage_fn(p, h):
        return torch.tanh(h @ p["w"] + p["b"])

    out = pipeline_apply(stage_fn, params, xl, mesh,
                         data_axes=plan.batch_axes())
    pp = mesh.group("pp")
    last = pp.rank == pp.size - 1
    res = {"stage": pp.rank, "rows": (r0, r1),
           "out": out.detach().numpy() if last else None}
    if loss:
        if last:
            val = (out ** 2).sum() / (xt.shape[0] * xt.shape[1] * xt.shape[2])
        else:
            val = out.sum() * 0.0
        val.backward()
        g = {k: v.grad[pp.rank].clone() for k, v in params.items()}
        from edl_tpu_torch.parallel import collectives as coll

        for t in g.values():  # the batch shards' parts of the gradient
            for a in plan.batch_axes():
                coll.all_reduce(t, mesh.group(a))
        res["grads"] = {k: t.numpy() for k, t in g.items()}
    return res


def sp_logits(params_np, cfg_kw, tokens, sizes):
    """``llama.forward`` over the mesh ``sizes`` on whole tokens [B, T]:
    this rank's rows and positions of the logits, and where they are."""
    from edl_tpu_torch.models import llama

    cfg = llama.LlamaConfig(**{**cfg_kw, "dtype": torch.float32})
    plan, mesh, _ = mesh_check.pool_mesh(sizes, "cpu")
    whole = params_from_numpy(mesh_check.unflat(params_np), device="cpu")
    st = trainer.shard_state(trainer.TrainState.create(whole,
                                                       trainer.sgd(0.0)),
                             plan, mesh,
                             param_pspecs=llama.param_pspecs(cfg, plan))
    rows = _batch_part(np.asarray(tokens), plan, mesh)
    with torch.no_grad():
        logits = llama.forward(st.params, rows, cfg, mesh=mesh, plan=plan)
    _, pos0 = shd.sequence_part(rows, mesh)
    return {"logits": logits.numpy(),
            "rows": _row_span(plan, mesh, tokens.shape[0]), "pos0": pos0}


def elastic_llama_sp(params_np, cfg_kw, schedule, seq=16, per_chip_batch=4,
                     lr=1e-3):
    """``ElasticTrainer(MeshSpec(sp=2), chips_per_worker=2)`` on llama
    (adam, the mesh loss rebuilt at each rescale) through ``schedule``
    [(workers, steps)]; rank 0's losses, plans, events and state step."""
    from edl_tpu_torch.models import llama

    cfg = llama.LlamaConfig(**{**cfg_kw, "dtype": torch.float32})
    tr = el.ElasticTrainer(
        None, trainer.adam(lr), mesh_spec=MeshSpec(sp=2),
        chips_per_worker=2, per_chip_batch=per_chip_batch,
        param_pspecs=lambda plan: llama.param_pspecs(cfg, plan),
        make_loss=lambda plan, mesh: llama.make_loss_fn(cfg, plan, mesh),
        device="cpu")
    tr.start(params_from_numpy(mesh_check.unflat(params_np), device="cpu"),
             schedule[0][0])
    rng = np.random.RandomState(0)

    def data(bs):
        return llama.synthetic_tokens(rng, bs, seq, cfg.vocab)

    plans = []
    for i, (n, steps) in enumerate(schedule):
        if i:
            tr.request_rescale(n)
        tr.train_steps(data, steps)
        plans.append(tr.plan.describe())
    return {"losses": tr.report.losses, "plans": plans,
            "events": [(e.from_workers, e.to_workers, e.step, e.fallback)
                       for e in tr.report.reshards],
            "state_step": None if tr.state is None else int(tr.state.step)}


# -- LocalJobRunner (tests/test_torch_local.py) -------------------------------


E2E_JOB_YAML = """
apiVersion: edl-tpu.org/v1
kind: TrainingJob
metadata: {name: fit-a-line}
spec:
  fault_tolerant: true
  passes: 2
  worker:
    entrypoint: "python train_ft.py"
    min_replicas: 2
    max_replicas: 4
    resources:
      requests: {cpu: "500m", memory: "1Gi", tpu: 2}
      limits: {tpu: 2}
"""


def _e2e_fleet(n=4):
    from edl_tpu_torch.cluster.fake import FakeCluster, FakeHost

    return FakeCluster(hosts=[FakeHost(f"h{i}", 8000, 16000, 2)
                              for i in range(n)])


def local_e2e(scenario, params_np, use_pool=True):
    """``tests/test_e2e.py``'s scenario ("grow": 2 → 4 workers by an
    autoscaler tick; "kill": a host dies and the job finishes on the
    live workers) with the port's ``LocalJobRunner`` at 1 chip a worker:
    the controller on rank 0 (the only rank with ``use_pool=False``).
    Rank 0 returns the losses, the phases at each check, the job's
    reshard count, status stall and the report's stalls, the final step
    and the workers."""
    from edl_tpu_torch.api.job import TrainingJob
    from edl_tpu_torch.controller.controller import Controller
    from edl_tpu_torch.runtime.data import ElasticDataQueue, QueueBatcher
    from edl_tpu_torch.runtime.local import LocalJobRunner

    lead = (not use_pool) or torch.distributed.get_rank() == 0
    job = TrainingJob.from_yaml(E2E_JOB_YAML)
    cluster = ctl = None
    phases = []

    def phase():
        if lead:
            phases.append(ctl.phase_of("fit-a-line").value)

    if lead:
        cluster = _e2e_fleet()
        ctl = Controller(cluster, max_load_desired=1.0)
        cluster.submit_job(job)
        ctl.step()
        if scenario == "kill":
            ctl.autoscaler.tick()  # grow to 4
    phase()
    params = params_from_numpy(params_np, device="cpu")
    if scenario == "grow":
        x, y = linreg.synthetic_dataset(2048)
        cursor = {"i": 0}

        def data_fn(bs):
            lo = cursor["i"] % (2048 - bs)
            cursor["i"] += bs
            return {"x": x[lo:lo + bs], "y": y[lo:lo + bs]}

        runner = LocalJobRunner(ctl, job, linreg.loss_fn, trainer.sgd(0.05),
                                params, chips_per_worker=1,
                                per_chip_batch=16, device="cpu")
        n0 = runner.trainer.n_workers
        runner.trainer.train_steps(data_fn, 5)
        if lead:
            ctl.autoscaler.tick()
        phase()
        report = runner.trainer.train_steps(data_fn, 5)
        phase()
        mid = (job.status.reshard_count, job.status.last_reshard_stall_s,
               [e.stall_s for e in report.reshards]) if lead else None
        report = runner.run(data_fn, n_steps=5)
    else:
        queue = ElasticDataQueue(n_samples=640, chunk_size=64, passes=1)
        x, y = linreg.synthetic_dataset(640)
        batcher = QueueBatcher(
            queue, lambda t: {"x": x[t.start:t.end], "y": y[t.start:t.end]})

        def data_fn(bs):
            b = batcher.next_batch(bs)
            if b is None:
                return {"x": x[:bs], "y": y[:bs]}
            if b["x"].shape[0] < bs:
                b = {k: np.resize(v, (bs,) + v.shape[1:])
                     for k, v in b.items()}
            return b

        runner = LocalJobRunner(ctl, job, linreg.loss_fn, trainer.sgd(0.05),
                                params, chips_per_worker=1,
                                per_chip_batch=8, device="cpu")
        n0 = runner.trainer.n_workers
        runner.trainer.train_steps(data_fn, 2)
        pods = None
        if lead:
            victim = next(p for p in cluster.pods.values()
                          if p.role == "worker")
            cluster.remove_host(victim.host)
        queue.release_worker("w-dead")
        if lead:
            cluster.reconcile()
            pods = cluster.job_pods(job)
            ctl.autoscaler.tick()
        phase()
        mid = pods
        report = runner.run(data_fn, queue=queue)
    phase()
    out = {"losses": report.losses, "steps": report.steps,
           "n0": n0, "workers": runner.trainer.n_workers,
           "state_step": None if runner.trainer.state is None
           else int(runner.trainer.state.step)}
    if lead:
        out.update(phases=phases, mid=mid,
                   reshard_count=job.status.reshard_count,
                   last_stall=job.status.last_reshard_stall_s,
                   stalls=[e.stall_s for e in report.reshards],
                   events=[(e.from_workers, e.to_workers, e.fallback)
                           for e in report.reshards],
                   live=runner.live_workers)
    return out
