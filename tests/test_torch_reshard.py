"""Port parity of the reshard path on one device: edl_tpu_torch's
``quant``, ``parallel.sharding`` (``to_host``, ``stream_reshard``),
``runtime.checkpoint`` (``snapshot``, ``restore``, ``staged_reshard``,
``save``/``load``, the stall models) and ``runtime.elastic``
(``device_reshard``) against edl_tpu's, on the CTR state (vocab 4096,
emb 8, ``adam(1e-3)``, one step taken so the moments are non-trivial).

Exactness where the reference has it: int8 q and scales bit for bit;
f32 staging bit-identical to snapshot + restore, and the next step after
it equal to the un-resharded step; the stall models equal. int8 staging
holds the reference's bound: params exact, moments within 1/127 of
their row's absmax.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from edl_tpu.models import ctr as jctr
from edl_tpu.ops import quant as jquant
from edl_tpu.runtime import checkpoint as jckpt
from edl_tpu.train.trainer import TrainState as JTrainState
from edl_tpu_torch.models import ctr as tctr
from edl_tpu_torch.models.convert import ctr_params_from_numpy
from edl_tpu_torch.ops import quant
from edl_tpu_torch.parallel import sharding as shd
from edl_tpu_torch.runtime import checkpoint as ckpt
from edl_tpu_torch.runtime import elastic
from edl_tpu_torch.train import trainer

torch.set_num_threads(1)

VOCAB, EMB = 4096, 8
JP = jctr.init_params(jax.random.PRNGKey(0), vocab=VOCAB, emb=EMB)


def _batch(seed):
    return trainer.global_batch(
        jctr.synthetic_batch(np.random.RandomState(seed), 64, vocab=VOCAB),
        device="cpu")


def _state():
    """The CTR state after one Adam step, and its step function."""
    tx = trainer.adam(1e-3)
    params = ctr_params_from_numpy(jax.tree_util.tree_map(np.asarray, JP),
                                   "cpu")
    state = trainer.TrainState.create(params, tx)
    step = trainer.make_train_step(tctr.make_loss_fn(), tx)
    state, _ = step(state, _batch(0))
    return state, step


def _moment(state, key="embedding", name="exp_avg"):
    return state.opt_state.state[state.params[key]][name]


def _all_tensors(state):
    return (trainer.leaves(state.params)
            + [t for _, _, t, _ in trainer.optimizer_tensors(state)])


def _keyed(state):
    """{key: tensor} of params and optimizer tensors, keyed by name (two
    trees may order a dict's keys differently)."""
    keys = ckpt._leaf_keys(state.params)
    out = dict(keys)
    out.update({f"{keys[i][0]}/{name}": t
                for i, name, t, _ in trainer.optimizer_tensors(state)})
    return out


def _assert_states_equal(a, b):
    assert a.step == b.step
    ka, kb = _keyed(a), _keyed(b)
    assert ka.keys() == kb.keys()
    for k in ka:
        assert ka[k].dtype == kb[k].dtype and torch.equal(ka[k], kb[k]), k


def test_quantize_int8_matches_reference():
    """q and scales equal the reference's bit for bit on Adam moments
    (rows of zeros included: untouched embedding rows) and on values
    planted at rounding ties."""
    state, _ = _state()
    ties = np.array([[0.5, -0.5, 1.5, 127.0], [2.5, -2.5, 0.0, 254.0]],
                    np.float32)
    for x in (_moment(state).numpy(),
              _moment(state, name="exp_avg_sq").numpy(), ties):
        q, s = quant.quantize_int8(torch.from_numpy(x))
        jq, js = jquant.quantize_int8(jnp.asarray(x))
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(s.numpy(), np.asarray(js))
        back = quant.dequantize_int8(q, s).numpy()
        np.testing.assert_array_equal(
            back, np.asarray(jquant.dequantize_int8(jq, js)))


def test_staged_reshard_f32_bit_identical_to_snapshot_restore(monkeypatch):
    """With 4 KiB pieces every leaf above 8 KiB streams in pieces through
    the staging ring (the reference's ``test_elastic`` pin)."""
    monkeypatch.setattr(shd, "_CHUNK_BYTES", 1 << 12)
    state, _ = _state()
    leaves = _all_tensors(state)
    assert len(shd._schedule(leaves)) > len(leaves) + shd._CHUNK_WINDOW
    out = ckpt.staged_reshard(state, stage="f32", device="cpu")
    ref = ckpt.restore(ckpt.snapshot(state), device="cpu")
    _assert_states_equal(out, ref)
    _assert_states_equal(out, state)
    # new tensors, and an optimizer bound to them
    assert not set(map(id, _all_tensors(out))) & set(map(id, leaves))
    assert set(map(id, trainer.leaves(out.params))) == {
        id(p) for g in out.opt_state.param_groups for p in g["params"]}


@pytest.mark.parametrize("how", ["staged_f32", "snapshot_restore",
                                 "device_reshard", "save_load"])
def test_next_step_after_reshard_equals_unresharded_step(how, tmp_path):
    state, step = _state()
    if how == "staged_f32":
        moved = ckpt.staged_reshard(state, stage="f32", device="cpu")
    elif how == "snapshot_restore":
        moved = ckpt.restore(ckpt.snapshot(state), device="cpu")
    elif how == "device_reshard":
        moved = elastic.device_reshard(state, device="cpu")
        assert moved is state  # same device: nothing moves
        moved = ckpt.restore(ckpt.snapshot(state), device="cpu")
    else:
        ckpt.save(str(tmp_path), state, {"job": "ctr"})
        like = trainer.TrainState.create(
            tctr.init_params(torch.Generator().manual_seed(5), vocab=VOCAB,
                             emb=EMB, device="cpu"), trainer.adam(1e-3))
        moved = ckpt.restore(ckpt.load(str(tmp_path), like), device="cpu")
        assert ckpt.load_metadata(str(tmp_path)) == {"job": "ctr"}
    _assert_states_equal(moved, state)
    b = _batch(1)
    a, ma = step(moved, b)
    c, mc = step(state, b)
    assert float(ma["loss"]) == float(mc["loss"])
    _assert_states_equal(a, c)


def _adafactor_state():
    """The CTR state after two adafactor steps: the 400 x 400 MLP
    weights factored (v_row, v_col), the [4096, 8] table and the biases
    whole (v)."""
    tx = trainer.adafactor(1e-3)
    params = ctr_params_from_numpy(jax.tree_util.tree_map(np.asarray, JP),
                                   "cpu")
    state = trainer.TrainState.create(params, tx)
    step = trainer.make_train_step(tctr.make_loss_fn(), tx)
    for i in range(2):
        state, _ = step(state, _batch(i))
    return state, step


@pytest.mark.parametrize("how", ["shard_state", "snapshot_restore",
                                 "save_load"])
def test_adamw_state_reshards_bit_for_bit(how, tmp_path):
    """An adamw state placed by ``shard_state``, restored from a
    snapshot and loaded from a checkpoint: each rebuilds its optimizer
    through ``rebind_state``, which under torch 2.13 must not pass
    ``AdamW.defaults``'s ``decoupled_weight_decay`` back to ``__init__``.
    The next step from each equals the original's, bit for bit."""
    tx = trainer.adamw(1e-3)
    params = ctr_params_from_numpy(jax.tree_util.tree_map(np.asarray, JP),
                                   "cpu")
    state = trainer.TrainState.create(params, tx)
    step = trainer.make_train_step(tctr.make_loss_fn(), tx)
    state, _ = step(state, _batch(0))
    if how == "shard_state":
        moved = trainer.shard_state(state, device="cpu")
    elif how == "snapshot_restore":
        moved = ckpt.restore(ckpt.snapshot(state), device="cpu")
    else:
        ckpt.save(str(tmp_path), state)
        like = trainer.TrainState.create(
            tctr.init_params(torch.Generator().manual_seed(5), vocab=VOCAB,
                             emb=EMB, device="cpu"), trainer.adamw(1e-3))
        moved = ckpt.restore(ckpt.load(str(tmp_path), like), device="cpu")
    assert type(moved.opt_state) is torch.optim.AdamW
    assert moved.opt_state.defaults == state.opt_state.defaults
    _assert_states_equal(moved, state)
    b = _batch(1)
    a, ma = step(moved, b)
    c, mc = step(state, b)
    assert float(ma["loss"]) == float(mc["loss"])
    _assert_states_equal(a, c)


@pytest.mark.parametrize("how", ["staged_f32", "snapshot_restore",
                                 "save_load"])
def test_adafactor_state_reshards_bit_for_bit(how, tmp_path, monkeypatch):
    monkeypatch.setattr(shd, "_CHUNK_BYTES", 1 << 12)
    state, step = _adafactor_state()
    names = {n for _, n, _, _ in trainer.optimizer_tensors(state)}
    assert names == {"step", "v_row", "v_col", "v"}
    if how == "staged_f32":
        moved = ckpt.staged_reshard(state, stage="f32", device="cpu")
    elif how == "snapshot_restore":
        moved = ckpt.restore(ckpt.snapshot(state), device="cpu")
    else:
        ckpt.save(str(tmp_path), state)
        like = trainer.TrainState.create(
            tctr.init_params(torch.Generator().manual_seed(5), vocab=VOCAB,
                             emb=EMB, device="cpu"), trainer.adafactor(1e-3))
        moved = ckpt.restore(ckpt.load(str(tmp_path), like), device="cpu")
    assert type(moved.opt_state) is trainer.Adafactor
    assert moved.opt_state.defaults == state.opt_state.defaults
    _assert_states_equal(moved, state)
    b = _batch(2)
    a, ma = step(moved, b)
    c, mc = step(state, b)
    assert float(ma["loss"]) == float(mc["loss"])
    _assert_states_equal(a, c)
    params = sum(p.nbytes for p in trainer.leaves(state.params))
    stats = sum(t.nbytes for _, n, t, _ in trainer.optimizer_tensors(state)
                if n != "step")
    assert ckpt.state_nbytes(a) == params + stats + 4 * len(
        trainer.leaves(state.params))
    assert stats < params / 2  # factored: far below Adam's 2x


def test_staged_reshard_int8_moment_staging(monkeypatch):
    """The reference's bound: params move exactly, Adam moments within
    1/127 of their row's absmax; the next step's loss from there is the
    un-resharded state's."""
    monkeypatch.setattr(shd, "_CHUNK_BYTES", 1 << 12)
    state, step = _state()
    out = ckpt.staged_reshard(state, stage="int8", device="cpu")
    for a, b in zip(trainer.leaves(state.params), trainer.leaves(out.params)):
        assert torch.equal(a, b)
    for name in ("exp_avg", "exp_avg_sq"):
        m0 = _moment(state, name=name).numpy()
        m1 = _moment(out, name=name).numpy()
        denom = np.maximum(np.abs(m0).max(axis=-1, keepdims=True), 1e-12)
        assert (np.abs(m0 - m1) / denom).max() <= 1 / 127 + 1e-6
    # small leaves (< 4096 elements) and the steps are staged exactly
    for i, name, t, _ in trainer.optimizer_tensors(state):
        if t.numel() < 4096:
            assert torch.equal(t, out.opt_state.state[
                trainer.leaves(out.params)[i]][name])
    # the next step's loss is taken at the staged params, which moved
    # exactly: it is the unstaged run's (the bound is 1e-3)
    b = _batch(1)
    _, mo = step(out, b)
    _, ms = step(state, b)
    assert float(mo["loss"]) == float(ms["loss"])


def test_staged_reshard_stage_selection(monkeypatch, caplog):
    state, _ = _state()
    with pytest.raises(ValueError, match="unknown reshard staging"):
        ckpt.staged_reshard(state, stage="fp8", device="cpu")
    monkeypatch.setenv("EDL_RESHARD_STAGE", "bf16")
    with caplog.at_level("INFO", logger="edl_tpu_torch.checkpoint"):
        out = ckpt.staged_reshard(state, device="cpu")
    assert "lossy moment compression" in caplog.text
    m0, m1 = _moment(state), _moment(out)
    assert m1.dtype == torch.float32
    assert torch.equal(m1, m0.to(torch.bfloat16).float())
    with pytest.raises(NotImplementedError, match="not ported"):
        ckpt.staged_reshard(state, mesh=object(), device="cpu")


def test_state_nbytes_counts_params_moments_and_steps():
    state, _ = _state()
    params = sum(p.numel() * 4 for p in trainer.leaves(state.params))
    opt = sum(t.nbytes for st in state.opt_state.state.values()
              for t in st.values())
    assert ckpt.state_nbytes(state) == params + opt
    assert ckpt.state_nbytes(state.opt_state) == opt
    assert ckpt.state_nbytes(state.params) == params
    # Adam: two f32 moments a param and one 4-byte step a leaf
    assert opt == 2 * params + 4 * len(trainer.leaves(state.params))


def test_stall_models_match_reference():
    assert ckpt.STAGE_MOMENT_FACTOR == jckpt.STAGE_MOMENT_FACTOR
    for state_b in (1 << 20, 17 << 30):
        for hosts in (1, 3, 8):
            for bw in (0.01 * (1 << 30), 12e9):
                for frac in (0.0, 0.25, 2 / 3):
                    for stage in ("f32", "bf16", "int8"):
                        kw = dict(moment_bytes=int(state_b * frac),
                                  stage=stage)
                        assert ckpt.host_fallback_stall_model(
                            state_b, hosts, bw, **kw) == (
                            jckpt.host_fallback_stall_model(
                                state_b, hosts, bw, **kw))
                assert ckpt.p2p_migrate_stall_model(state_b, hosts, bw) == (
                    jckpt.p2p_migrate_stall_model(state_b, hosts, bw))
    for bad in ((1, 0, 1.0), (1, 1, 0.0)):
        with pytest.raises(ValueError):
            ckpt.host_fallback_stall_model(*bad)
    with pytest.raises(ValueError, match="outside"):
        ckpt.host_fallback_stall_model(10, 1, 1.0, moment_bytes=11)
    with pytest.raises(ValueError, match="staging mode"):
        ckpt.host_fallback_stall_model(10, 1, 1.0, stage="fp8")


def test_loads_the_params_of_a_reference_checkpoint(tmp_path):
    """The ``p:`` keys are shared: the port reads the params of a
    checkpoint the reference's ``save`` wrote."""
    tx = optax.adam(1e-3)
    jckpt.save(str(tmp_path), JTrainState.create(JP, tx), {"job": "ref"})
    like = tctr.init_params(torch.Generator().manual_seed(1), vocab=VOCAB,
                            emb=EMB, device="cpu")
    got = ckpt.load_params(str(tmp_path), like)
    want = ctr_params_from_numpy(jax.tree_util.tree_map(np.asarray, JP),
                                 "cpu")
    assert [k for k, _ in ckpt._leaf_keys(got)] == [
        k for k, _ in ckpt._leaf_keys(like)]
    want = dict(ckpt._leaf_keys(want))
    for k, a in ckpt._leaf_keys(got):
        assert torch.equal(a, want[k]), k
    assert ckpt.load_metadata(str(tmp_path)) == {"job": "ref"}
    with np.load(tmp_path / "state.npz") as z:
        assert {f"p:{k}" for k, _ in ckpt._leaf_keys(like)} <= set(z.files)
    bad = dict(like, embedding=torch.zeros(2, 2))
    with pytest.raises(ValueError, match="shape mismatch"):
        ckpt.load_params(str(tmp_path), bad)


def test_to_host_and_stream_reshard_on_the_cpu(monkeypatch):
    """The pipeline's schedule and ring at a tiny piece size: pieces of
    equal rows (the last ragged), every leaf placed whole on its target,
    scalars and small leaves whole."""
    monkeypatch.setattr(shd, "_CHUNK_BYTES", 1 << 10)
    x = torch.arange(4096, dtype=torch.float32).reshape(512, 8)
    y = torch.tensor(3.0)
    z = torch.arange(6, dtype=torch.int8)
    sched = shd._schedule([x, y, z])
    assert sched[0] == (0, 0, 32) and sched[-3] == (0, 480, 512)
    assert sched[-2:] == [(1, None, None), (2, None, None)]
    out = shd.stream_reshard([x, y, z], ["cpu"] * 3)
    for a, b in zip(out, (x, y, z)):
        assert a is not b and a.dtype == b.dtype and torch.equal(a, b)
    host = shd.to_host({"a": x, "b": [y]})
    assert torch.equal(host["a"], x) and host["a"] is not x
    assert torch.equal(host["b"][0], y)


def _int8_resumed(n_steps=6):
    """The CTR state after ``n_steps`` Adam steps, its int8-staged copy,
    and one step from each (the staged one and an unstaged copy)."""
    state, step = _state()
    for i in range(1, n_steps):
        state, _ = step(state, _batch(i))
    staged = ckpt.staged_reshard(state, stage="int8", device="cpu")
    plain = ckpt.restore(ckpt.snapshot(state), device="cpu")
    return state, staged, plain, step


def test_chip_smoke_int8_reshard_gates_hold_on_the_cpu():
    """chip_smoke's reshard gates on a trained CPU state: every gate
    passes, and the params one step after int8 staging stay within the
    bound the 1/127 moment errors give Adam's update."""
    import chip_smoke

    state, _, _, step = _int8_resumed()
    worst, resumed, zeroed = chip_smoke._ctr_gates_reshard(
        state, step, _batch(9), ckpt, trainer, "cpu")
    assert 0 < worst <= 1 / 127 + 1e-6
    assert 0 < resumed["param_worst_of_bound"] <= 1
    assert resumed["param_max_abs_diff"] > 0  # the staged moments moved it
    assert 0 <= zeroed < 1


@pytest.mark.parametrize("fault", ["first_moment_3pct", "lr_doubled",
                                   "moments_dropped"])
def test_chip_smoke_int8_resume_check_trips(fault):
    """The resumed-step check trips on what the moment gate cannot see:
    the first moments of the int8-staged leaves 3% off (3.8x the staging
    bound, applied after the moment gate: the bound is tight there, not
    only on the leaves staged exactly), an optimizer rebuilt with another
    learning rate, and an optimizer that lost its moments."""
    import chip_smoke

    state, staged, plain, step = _int8_resumed()
    for p in trainer.leaves(staged.params):
        st = staged.opt_state.state[p]
        if fault == "first_moment_3pct" and p.numel() >= 4096:
            st["exp_avg"].mul_(1.03)
        elif fault == "moments_dropped":
            st["exp_avg"].zero_()
            st["exp_avg_sq"].zero_()
    if fault == "lr_doubled":
        for g in staged.opt_state.param_groups:
            g["lr"] *= 2
    b = _batch(9)
    staged, _ = step(staged, b)
    plain, _ = step(plain, b)
    with pytest.raises(AssertionError, match="of the bound"):
        chip_smoke._ctr_resume_check(state, staged, plain, trainer)
