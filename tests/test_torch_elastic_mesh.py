"""Port parity of ``runtime/elastic.ElasticTrainer`` and the sharded half
of ``runtime/checkpoint``: the twins of ``tests/test_elastic.py`` on a
pool of four gloo processes on the CPU (``utils/platform.ProcessPool``,
one for the module; every rank runs the same trainer, rank 0 reports).

The reference's pool is 8 virtual devices; the port's is 4 processes, so
the twins use ``chips_per_worker=1`` where the reference used 2 (the same
worker counts and meshes of half the devices), and the reference runs
the same schedule on ``cpu_devices[:4]`` for the loss comparisons.
"""

import jax
import numpy as np
import optax
import pytest
import torch

from edl_tpu.api.job import MeshSpec as JMeshSpec
from edl_tpu.models import ctr as jctr
from edl_tpu.models import linreg as jlinreg
from edl_tpu.models import llama as jl
from edl_tpu.runtime.elastic import ElasticTrainer as JElastic
from edl_tpu_torch.ops import quant
from edl_tpu_torch.train import mesh_check
from edl_tpu_torch.utils.platform import ProcessPool
from tests import torch_pool_cases as cases

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def pool():
    with ProcessPool(4, device="cpu", timeout_s=240, threads=1) as p:
        yield p


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jlinreg_data_fn():
    x, y = jlinreg.synthetic_dataset(4096)
    state = {"i": 0}

    def fn(batch_size):
        lo = state["i"] % (4096 - batch_size)
        state["i"] += batch_size
        return {"x": x[lo: lo + batch_size], "y": y[lo: lo + batch_size]}

    return fn


def test_elastic_rescale_preserves_training(pool, cpu_devices):
    """Twin of test_elastic.py:32: linreg with sgd(0.05), 2 -> 4 -> 1
    workers, 10 steps each; the losses equal the reference's trainer on
    the same data within 1e-5."""
    p = jlinreg.init_params(jax.random.PRNGKey(0))
    out = pool.run(cases.elastic_linreg, _np(p), [(2, 10), (4, 10), (1, 10)])
    got = out[0]
    jt = JElastic(jlinreg.loss_fn, optax.sgd(0.05), chips_per_worker=1,
                  per_chip_batch=16, devices=cpu_devices[:4])
    jt.start(p, n_workers=2)
    data = _jlinreg_data_fn()
    jt.train_steps(data, 10)
    jt.request_rescale(4)
    jt.train_steps(data, 10)
    jt.request_rescale(1)
    jt.train_steps(data, 10)
    np.testing.assert_allclose(got["losses"], jt.report.losses, rtol=1e-5,
                               atol=1e-6)
    assert [e[:3] for e in got["events"]] == [(2, 4, 10), (4, 1, 20)]
    assert all(e[4] < 30.0 and not e[3] for e in got["events"])
    assert got["steps"] == 30 and got["state_step"] == 30
    assert got["n_devices"] == 1 and got["batch"] == 16
    assert got["losses"][-1] < got["losses"][0] * 0.5
    # every rank reports the same losses; only rank 0 holds state at 1
    assert all(o["losses"] == got["losses"] for o in out)
    assert [o["member"] for o in out] == [True, False, False, False]
    for k, v in mesh_check.flat(_np(jt.state.params)).items():
        np.testing.assert_allclose(got["final"]["params"][k], v, rtol=1e-5,
                                   atol=1e-6)


def test_reshard_is_bitexact(pool):
    """Twin of test_elastic.py:68 (adam, 2 -> 4 workers): the state
    gathered before and after the rescale is the same bit for bit."""
    p = jlinreg.init_params(jax.random.PRNGKey(1))
    got = pool.run(cases.elastic_linreg, _np(p), [(2, 5), (4, 1), (1, 1)],
                   "adam", 1e-2)[0]
    for a, b in zip(got["snaps"][::2], got["snaps"][1::2]):
        assert a["step"] == b["step"]
        for k in a["params"]:
            np.testing.assert_array_equal(a["params"][k], b["params"][k])
        assert set(a["opt"]) == set(b["opt"])
        for k in a["opt"]:
            np.testing.assert_array_equal(a["opt"][k], b["opt"][k])


def test_reshard_event_flags_host_fallback(pool):
    """Twin of test_elastic.py:206: when the device path raises, the
    rescale completes through host staging and its event says so; the
    host path moves the state exactly (f32 staging of sgd's state)."""
    p = jlinreg.init_params(jax.random.PRNGKey(0))
    got = pool.run(cases.elastic_linreg, _np(p), [(2, 2), (4, 2), (2, 2)],
                   fail_device=True)[0]
    assert [e[3] for e in got["events"]] == [True, True]
    for a, b in zip(got["snaps"][::2], got["snaps"][1::2]):
        for k in a["params"]:
            np.testing.assert_array_equal(a["params"][k], b["params"][k])
    fast = pool.run(cases.elastic_linreg, _np(p), [(2, 2), (4, 2)])[0]
    assert [e[3] for e in fast["events"]] == [False]
    np.testing.assert_allclose(got["losses"][:4], fast["losses"], rtol=1e-6)


def test_device_reshard_failing_on_one_rank_falls_back_on_every_rank(pool):
    """The device path's local part (its layout and allocations) raises
    on rank 1 alone, as a CUDA OOM on a shared card would: the pool
    agrees before any slice moves, so every rank takes the host path
    (no rank is left in a transfer), each event says so on every rank,
    and the state moves exactly."""
    p = jlinreg.init_params(jax.random.PRNGKey(0))
    out = pool.run(cases.elastic_linreg, _np(p), [(2, 2), (4, 2), (2, 2)],
                   fail_device=1)
    for o in out:
        assert [e[3] for e in o["events"]] == [True, True]
    got = out[0]
    for a, b in zip(got["snaps"][::2], got["snaps"][1::2]):
        for k in a["params"]:
            np.testing.assert_array_equal(a["params"][k], b["params"][k])
    assert got["state_step"] == 6 and got["steps"] == 6


def test_device_reshard_bug_on_one_rank_fails_every_rank():
    """A failure of the device path's local part that the fallback does
    not take (a KeyError, a bug) on rank 1 alone makes every rank raise
    at once: the pool call fails with the rank's error, well before the
    pool's timeout, instead of ranks 0, 2 and 3 going on into the host
    path without it."""
    from edl_tpu_torch.utils.platform import PoolError

    p = jlinreg.init_params(jax.random.PRNGKey(0))
    with ProcessPool(4, device="cpu", timeout_s=120, threads=1) as bad:
        with pytest.raises(PoolError, match="KeyError|PeerError"):
            bad.run(cases.elastic_linreg, _np(p), [(2, 1), (4, 1)],
                    fail_device=1, fail_kind=KeyError)


def test_elastic_fsdp_ctr(pool, cpu_devices):
    """Twin of test_elastic.py:84: CTR on MeshSpec(fsdp=2), 1 -> 2
    workers of 2 chips; the embedding slice is (2048, 8) on every rank
    before and after (fsdp stays 2, dp grows), and the losses follow the
    reference's trainer on the same schedule."""
    p = jctr.init_params(jax.random.PRNGKey(0), vocab=4096, emb=8)
    out = pool.run(cases.elastic_ctr_fsdp, _np(p))
    got = out[0]
    assert got["plans"] == ({"fsdp": 2}, {"dp": 2, "fsdp": 2})
    for r, o in enumerate(out):
        assert o["shapes"] == (((2048, 8) if r < 2 else None), (2048, 8))
    assert got["stall"] < 30.0
    jt = JElastic(jctr.loss_fn, optax.adam(1e-2),
                  mesh_spec=JMeshSpec(fsdp=2), chips_per_worker=2,
                  per_chip_batch=32, devices=cpu_devices[:4])
    jt.start(p, n_workers=1)
    rng = np.random.RandomState(0)

    def data(bs):
        return jctr.synthetic_batch(rng, bs, vocab=4096)

    jt.train_steps(data, 5)
    jt.request_rescale(2)
    jt.train_steps(data, 5)
    # the first loss is before any update: the same forward
    np.testing.assert_allclose(got["losses"][0], jt.report.losses[0],
                               rtol=1e-6)
    # Adam at lr 1e-2 moves every embedding row a gradient touches by up
    # to lr, whatever the gradient's size, so the summation order's
    # rounding of the near-zero entries (collectives vs XLA) grows into
    # the trajectory: 1e-5 relative at step 2, 1e-3 by step 10
    np.testing.assert_allclose(got["losses"], jt.report.losses, rtol=2e-3)


def _ctr_np(vocab):
    return _np(jctr.init_params(jax.random.PRNGKey(0), vocab=vocab, emb=8))


def _assert_states_equal(a, b):
    assert a["step"] == b["step"]
    for part in ("params", "opt"):
        assert set(a[part]) == set(b[part])
        for k in a[part]:
            np.testing.assert_array_equal(a[part][k], b[part][k], err_msg=k)


def test_staged_reshard_preserves_state_across_mesh_change(pool):
    """Twin of test_elastic.py:124: staged_reshard (f32) from dp4 onto
    dp2 equals restore(snapshot) bit for bit, with 4 KiB pieces."""
    out = pool.run(cases.staged_vs_restore, _ctr_np(2048), 2048,
                   dict(dp=4), dict(dp=2), 1 << 12, "f32")
    got = out[0]
    _assert_states_equal(got["staged"], got["restored"])
    _assert_states_equal(got["staged"], got["before"])
    assert [o["step"] for o in out] == [1, 1, None, None]


def test_staged_reshard_onto_fsdp_mesh(pool):
    """Twin of test_elastic.py:165: from one rank onto a 4-way fsdp mesh
    with an odd piece size; each rank holds a (512, 8) slice of the
    2048-row table and the state equals restore(snapshot) bit for bit."""
    out = pool.run(cases.staged_vs_restore, _ctr_np(2048), 2048,
                   dict(dp=1), dict(fsdp=4), 3 << 10, "f32")
    got = out[0]
    _assert_states_equal(got["staged"], got["restored"])
    _assert_states_equal(got["staged"], got["before"])
    assert {o["shape"] for o in out} == {(512, 8)}


def test_staged_reshard_int8_moment_staging(pool):
    """Twin of test_elastic.py:229: int8 staging from dp4 onto dp2 x
    fsdp2 moves params exactly and each Adam moment as the whole
    moment's row-absmax int8 round trip, bit for bit (the rows of a
    moment split over fsdp take their absmax over the whole row)."""
    got = pool.run(cases.staged_vs_restore, _ctr_np(4096), 4096,
                   dict(dp=4), dict(dp=2, fsdp=2), 8 << 20, "int8")[0]
    before, after = got["before"], got["staged"]
    for k in before["params"]:
        np.testing.assert_array_equal(before["params"][k],
                                      after["params"][k])
    for k, m0 in before["opt"].items():
        m1 = after["opt"][k]
        if m0.dtype == np.float32 and m0.ndim >= 1 and m0.size >= 4096:
            q, s = quant.quantize_int8(torch.tensor(m0))
            want = quant.dequantize_int8(q, s).numpy()
            np.testing.assert_array_equal(m1, want, err_msg=k)
            denom = np.maximum(np.abs(m0).max(axis=-1, keepdims=True), 1e-12)
            assert (np.abs(m0 - m1) / denom).max() <= 1 / 127 + 1e-6
        else:
            np.testing.assert_array_equal(m1, m0, err_msg=k)


def test_checkpoint_roundtrip_of_sliced_pieces(pool, tmp_path):
    """Twin of test_elastic.py:112 for the sharded format: a llama tiny
    state on fsdp2 x tp2 written as sliced pieces (each rank's primary
    pieces tile every leaf once), read back onto dp2 x fsdp2 (each
    member reads only its slices) and whole on one process — both equal
    the written state bit for bit."""
    p = mesh_check.flat(_np(jl.init_params(jax.random.PRNGKey(0),
                                           jl.LlamaConfig.tiny())))
    kw = dict(vocab=256, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
              d_ff=128)
    out = pool.run(cases.checkpoint_roundtrip, p, str(tmp_path), kw,
                   dict(fsdp=2, tp=2), dict(dp=2, fsdp=2))
    got = out[0]
    _assert_states_equal(got["loaded"], got["src"])
    _assert_states_equal(got["whole"], got["src"])
    assert {o["local_wq"] for o in out} == {(2, 32, 64)}
    # the primary pieces of the four ranks tile wq [2, 64, 64] once
    prim = [o["primary"]["p:layers/wq"] for o in out]
    assert sorted(off for pr in prim for off in pr) == \
        [(0, 0, 0), (0, 0, 32), (0, 32, 0), (0, 32, 32)]


def test_chip_smoke_mesh_phase_runs_on_the_cpu():
    """chip_smoke.py's mesh phase end to end on a CPU pool at llama tiny
    (T=128; the launch gates need the card's kernels): the three plans
    against the one-rank steps, the elastic 1 -> 2 -> 1 job, every gate."""
    import chip_smoke

    kw = dict(vocab=256, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
              d_ff=128, dtype="float32", use_flash=True, remat=True)
    c = dict(chip_smoke.MESH, seq=128, timeout_s=240)
    launches = chip_smoke.mesh_phase("cpu", device="cpu", cfg_kw=kw, c=c,
                                     expect_launches=False)
    assert set(launches) == {chip_smoke.MESH_TP_SHAPE,
                             chip_smoke.MESH_FSDP_SHAPE}


def test_checkpoint_and_resume_across_worker_counts(pool, tmp_path):
    """``maybe_checkpoint`` on an fsdp mesh writes the whole state (the
    pool's first rank gathers it), and ``resume`` on another worker
    count places it back bit for bit (ranks outside the new mesh hold
    nothing)."""
    out = pool.run(cases.elastic_checkpoint_resume, _ctr_np(2048),
                   str(tmp_path))
    got = out[0]
    assert got["written"] and got["step"] == 3
    _assert_states_equal(got["resumed"], got["at3"])
    assert [o["shape"] for o in out] == [(1024, 8), (1024, 8), None, None]
