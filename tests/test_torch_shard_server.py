"""The port's p2p shard plane (``runtime/shard_server.py``,
``runtime/p2p_restore.py`` and the peer half of
``runtime/checkpoint.py``) held against the JAX package's: each side's
client fetches the other side's server bit for bit (bf16 included),
token auth, a missing piece, a snapshot swap, a close racing a parallel
``get_many``, the piece index's source priority and rank-skew filter, a
pure-peer restore equal to the restore from disk, and the restore
plane's timeout and bail cases on the native coordinator.
"""

import threading
import time
from types import SimpleNamespace

import ml_dtypes
import numpy as np
import pytest
import torch

from edl_tpu.runtime import checkpoint as jckpt
from edl_tpu.runtime import shard_server as jss
from edl_tpu_torch.models import ctr
from edl_tpu_torch.runtime import checkpoint as tckpt
from edl_tpu_torch.runtime import coordinator as tcoord
from edl_tpu_torch.runtime import shard_server as tss
from edl_tpu_torch.runtime.epoch_gc import EpochKeyGC
from edl_tpu_torch.runtime.p2p_restore import (_VETO_TTL_EPOCHS,
                                               P2PRestorePlane, _veto_active)
from edl_tpu_torch.train import trainer as ttrainer


def _addr(srv):
    return f"127.0.0.1:{srv.port}"


def _ref_snapshot(step=3, bf16_as_uint16=True):
    """A reference LocalSnapshot: f32 pieces of one leaf at two offsets,
    a bf16 leaf, an int32 leaf and a scalar. The reference's server
    sends a piece as a memoryview, which numpy refuses for ml_dtypes'
    bf16 ("cannot include dtype 'E' in a buffer"), so a bf16 leaf it
    can serve is held as its uint16 view, the port's form."""
    rs = np.random.RandomState(0)
    w = rs.randn(8, 6).astype(np.float32)
    h = rs.randn(5, 7).astype(ml_dtypes.bfloat16)
    pieces = {
        "p:w": [((0, 0), w[:4]), ((4, 0), w[4:])],
        "p:h": [((0, 0), h.view(np.uint16) if bf16_as_uint16 else h)],
        "p:ids": [((0,), np.arange(9, dtype=np.int32))],
        "o:count": [((), np.asarray(7, np.int32))],
    }
    return jckpt.LocalSnapshot(
        step=step, pieces=pieces,
        primary={k: [o for o, _ in v] for k, v in pieces.items()},
        shapes={"p:w": (8, 6), "p:h": (5, 7), "p:ids": (9,),
                "o:count": ()},
        dtypes={k: str(v[0][1].dtype) for k, v in pieces.items()})


def _bf16_state():
    """A port TrainState with a bf16 leaf beside f32 ones, after one
    Adam step (so the optimizer holds moments of both dtypes)."""
    gen = torch.Generator().manual_seed(0)
    params = {"w": torch.randn(6, 4, generator=gen),
              "h": torch.randn(5, 3, generator=gen).to(torch.bfloat16),
              "b": torch.zeros(4)}
    tx = ttrainer.adam(1e-2)
    st = ttrainer.TrainState.create(params, tx)
    for p in ttrainer.leaves(st.params):
        p.grad = torch.ones_like(p)
    st.opt_state.step()
    st.step = 1
    return st, tx


def _bytes(a):
    return np.ascontiguousarray(a).view(np.uint8).tobytes()


def _raw(t):
    return t.detach().reshape(-1).view(torch.uint8).numpy().tobytes()


def test_snapshot_local_holds_bf16_leaves_as_uint16_views():
    st, tx = _bf16_state()
    snap = tckpt.snapshot_local(st)
    assert snap.dtypes["p:h"] == "bfloat16"
    (_, arr), = snap.pieces["p:h"]
    assert arr.dtype == np.uint16 and arr.shape == (5, 3)
    want = st.params["h"].detach().view(torch.int16).numpy().view(np.uint16)
    np.testing.assert_array_equal(arr, want)
    # and back, bit for bit, moments included
    back = tckpt.restore_local(tx, snap, device="cpu")
    assert back.params["h"].dtype == torch.bfloat16
    for a, b in zip(ttrainer.leaves(st.params), ttrainer.leaves(back.params)):
        assert a.dtype == b.dtype and _raw(a) == _raw(b)
    got = {(i, n): t for i, n, t, _ in ttrainer.optimizer_tensors(back)}
    for i, n, t, _ in ttrainer.optimizer_tensors(st):
        assert got[(i, n)].dtype == t.dtype
        assert _raw(got[(i, n)]) == _raw(t), (i, n)


def test_port_fetches_the_reference_server_bit_for_bit():
    snap = _ref_snapshot()
    srv = jss.ShardServer(lambda: snap)
    try:
        step, entries = tss.fetch_index(_addr(srv))
        assert step == 3
        # the port reads the bf16 leaf under its own name
        key_h = jckpt._piece_key("p:h", (0, 0), (5, 7))
        entries[key_h] = "bfloat16"
        rp = tss.RemotePieces(_addr(srv), entries, nconn=3)
        got = rp.get_many(list(entries))
        for key, plist in snap.pieces.items():
            for off, arr in plist:
                g = got[jckpt._piece_key(key, off, arr.shape)]
                assert g.shape == arr.shape
                assert _bytes(g) == _bytes(arr), key
        h = tckpt.to_tensor(got[key_h], "bfloat16")
        assert h.dtype == torch.bfloat16
        np.testing.assert_array_equal(
            h.float().numpy(), snap.pieces["p:h"][0][1].view(
                ml_dtypes.bfloat16).astype(np.float32))
        rp.close()
    finally:
        srv.close()
    # the reference's server cannot send an ml_dtypes bf16 piece: the
    # fetch ends in a closed connection
    snap = _ref_snapshot(bf16_as_uint16=False)
    srv = jss.ShardServer(lambda: snap)
    try:
        _, entries = tss.fetch_index(_addr(srv))
        rp = tss.RemotePieces(_addr(srv), entries, nconn=1)
        with pytest.raises(OSError):
            rp[jckpt._piece_key("p:h", (0, 0), (5, 7))]
        rp.close()
    finally:
        srv.close()


def test_reference_fetches_the_port_server_bit_for_bit():
    st, _ = _bf16_state()
    snap = tckpt.snapshot_local(st)
    srv = tss.ShardServer(lambda: snap)
    try:
        step, entries = jss.fetch_index(_addr(srv))
        assert step == 1
        key_h = jckpt._piece_key("p:h", (0, 0), (5, 3))
        bf16 = {e for e, d in entries.items() if d == "bfloat16"}
        # the param and its two Adam moments
        assert key_h in bf16 and len(bf16) == 3
        # the reference's client receives into a memoryview of the
        # piece's array, which numpy refuses for ml_dtypes' bf16: it
        # reads the bf16 pieces' bytes as uint16
        entries.update({e: "uint16" for e in bf16})
        rp = jss.RemotePieces(_addr(srv), entries, nconn=2)
        got = rp.get_many(list(entries))
        for key, plist in snap.pieces.items():
            for off, arr in plist:
                assert _bytes(got[jckpt._piece_key(key, off, arr.shape)]) \
                    == _bytes(arr), key
        np.testing.assert_array_equal(
            got[key_h].view(ml_dtypes.bfloat16),
            st.params["h"].detach().float().numpy().astype(
                ml_dtypes.bfloat16))
        rp.close()
    finally:
        srv.close()


@pytest.mark.parametrize("client", ["port", "reference"])
def test_token_auth_gates_the_port_server(client):
    mod = tss if client == "port" else jss
    st, _ = _bf16_state()
    snap = tckpt.snapshot_local(st)
    srv = tss.ShardServer(lambda: snap, check_token=lambda t: t == "s3cret")
    try:
        assert mod.fetch_index(_addr(srv)) is None
        assert mod.fetch_index(_addr(srv), token="wrong") is None
        step, entries = mod.fetch_index(_addr(srv), token="s3cret")
        assert step == 1
        bad = mod.RemotePieces(_addr(srv), entries, token="wrong", nconn=1)
        with pytest.raises(OSError):
            bad[next(iter(entries))]
        bad.close()
        good = mod.RemotePieces(_addr(srv), entries, token="s3cret", nconn=1)
        e = jckpt._piece_key("p:w", (0, 0), (6, 4))
        np.testing.assert_array_equal(good[e], st.params["w"].detach().numpy())
        good.close()
    finally:
        srv.close()


def test_a_missing_piece_raises_and_the_snapshot_swaps():
    holder = {"snap": None}
    srv = tss.ShardServer(lambda: holder["snap"])
    try:
        assert tss.fetch_index(_addr(srv)) == (-1, {})
        st, _ = _bf16_state()
        holder["snap"] = tckpt.snapshot_local(st)
        step, entries = tss.fetch_index(_addr(srv))
        assert step == 1 and len(entries) == 3 + 3 * 3
        gone = jckpt._piece_key("p:gone", (0,), (4,))
        rp = tss.RemotePieces(_addr(srv), dict(entries, **{gone: "float32"}),
                              nconn=1)
        with pytest.raises(KeyError, match="lost pieces"):
            rp.get_many(list(entries) + [gone])
        # the stripe's good frames were read off the wire: the pooled
        # connection still serves the next batch
        e = jckpt._piece_key("p:b", (0,), (4,))
        np.testing.assert_array_equal(rp.get_many([e])[e],
                                      st.params["b"].detach().numpy())
        rp.close()
    finally:
        srv.close()


def test_close_during_a_parallel_get_many_is_clean():
    w = np.arange(1 << 16, dtype=np.float32).reshape(64, 1024)
    pieces = {"p:w": [((i * 8, 0), w[i * 8:(i + 1) * 8]) for i in range(8)]}
    snap = tckpt.LocalSnapshot(step=1, pieces=pieces,
                               primary={"p:w": []}, shapes={"p:w": w.shape},
                               dtypes={"p:w": "float32"})
    srv = tss.ShardServer(lambda: snap)
    try:
        _, entries = tss.fetch_index(_addr(srv))
        for _ in range(5):
            rp = tss.RemotePieces(_addr(srv), entries, nconn=4)
            out = {}

            def run():
                try:
                    out["got"] = rp.get_many(list(entries))
                except (OSError, ValueError, KeyError) as e:
                    out["err"] = e

            t = threading.Thread(target=run)
            t.start()
            rp.close()
            t.join(10)
            assert not t.is_alive()
            if "got" in out:
                for off, arr in pieces["p:w"]:
                    np.testing.assert_array_equal(
                        out["got"][jckpt._piece_key("p:w", off, arr.shape)],
                        arr)
    finally:
        srv.close()


class _FakeRemote:
    def __init__(self, arrays):
        self._a = arrays

    def entries(self):
        return list(self._a)

    def __getitem__(self, entry):
        return self._a[entry]


def test_piece_index_priority_is_disk_then_peer_then_ram(tmp_path):
    """At equal geometry: disk < remote peer < local RAM, as the
    reference's; an entry of another rank than its leaf's is dropped."""
    def snap(v):
        return tckpt.LocalSnapshot(
            step=2, pieces={"p:w": [((0, 0), np.full((2, 3), v, np.float32))]},
            primary={"p:w": [(0, 0)]}, shapes={"p:w": (2, 3)},
            dtypes={"p:w": "float32"})

    f = tckpt.save_shards(str(tmp_path), snap(1.0), 0, 1, host_leaves=True)
    tckpt.write_manifest(str(tmp_path), snap(1.0), [f])
    m = tckpt.latest_manifest(str(tmp_path))
    e = jckpt._piece_key("p:w", (0, 0), (2, 3))
    peer = _FakeRemote({e: np.full((2, 3), 2.0, np.float32)})
    whole = (slice(0, 2), slice(0, 3))
    for ram, remotes, want in ((None, [], 1.0), (None, [peer], 2.0),
                               (snap(3.0), [peer], 3.0)):
        for mod in (tckpt, jckpt):
            idx = mod._PieceIndex(m, ram, remotes=remotes,
                                  shapes={"p:w": (2, 3)})
            got = idx.assemble("p:w", whole, (2, 3), np.float32)
            idx.close()
            assert (got == want).all(), (mod.__name__, want)

    class Skewed(_FakeRemote):
        def __getitem__(self, entry):
            raise AssertionError("a skewed entry must never be fetched")

    skew = Skewed({jckpt._piece_key("p:w", (0,), (6,)): None})
    for mod in (tckpt, jckpt):
        idx = mod._PieceIndex(None, snap(4.0), remotes=[skew],
                              shapes={"p:w": (2, 3)})
        assert (idx.assemble("p:w", whole, (2, 3), np.float32) == 4.0).all()
    # a hole raises in both
    for mod in (tckpt, jckpt):
        half = _FakeRemote({jckpt._piece_key("p:w", (0, 0), (1, 3)):
                            np.ones((1, 3), np.float32)})
        idx = mod._PieceIndex(None, None, remotes=[half])
        with pytest.raises(ValueError, match="coverage"):
            idx.assemble("p:w", whole, (2, 3), np.float32)
    for boxes in ([((0,), (2,)), ((2,), (2,))], [((0,), (3,)), ((1,), (2,))],
                  [((), ())], []):
        shape = (4,) if boxes and boxes[0][0] else ()
        assert tckpt._boxes_tile(shape, boxes) == jckpt._boxes_tile(shape,
                                                                   boxes)


def _ctr_state():
    gen = torch.Generator().manual_seed(1)
    tx = ttrainer.adam(1e-3)
    st = ttrainer.TrainState.create(
        ctr.init_params(gen, vocab=64, emb=8, device="cpu"), tx)
    step = ttrainer.make_train_step(ctr.loss_fn, tx)
    b = ctr.synthetic_batch(np.random.RandomState(0), 16, vocab=64)
    for _ in range(2):
        st, _ = step(st, ttrainer.global_batch(b, device="cpu"))
    return st, tx


def _assert_states_equal(a, b):
    assert a.step == b.step
    for x, y in zip(ttrainer.leaves(a.params), ttrainer.leaves(b.params)):
        assert torch.equal(x, y)
    got = {(i, n): t for i, n, t, _ in ttrainer.optimizer_tensors(b)}
    want = ttrainer.optimizer_tensors(a)
    assert len(got) == len(want)
    for i, n, t, _ in want:
        assert torch.equal(got[(i, n)], t), (i, n)


def test_a_pure_peer_restore_equals_the_restore_from_disk(tmp_path):
    """Two peers each serve half of a dp state's leaves; a process with
    no RAM and no manifest assembles the state from them, bit for bit
    the state ``load_sharded`` reads back from the same commit."""
    st, tx = _ctr_state()
    snap = tckpt.snapshot_local(st)
    f = tckpt.save_shards(str(tmp_path), snap, 0, 1, host_leaves=True)
    tckpt.write_manifest(str(tmp_path), snap, [f])
    from_disk = tckpt.load_sharded(str(tmp_path), tx, device="cpu")

    keys = sorted(snap.pieces)
    halves = [tckpt.LocalSnapshot(
        step=snap.step, pieces={k: snap.pieces[k] for k in keys[i::2]},
        primary={}, shapes=snap.shapes, dtypes=snap.dtypes)
        for i in range(2)]
    servers = [tss.ShardServer(lambda h=h: h) for h in halves]
    remotes = []
    try:
        for srv in servers:
            step, entries = tss.fetch_index(_addr(srv))
            assert step == snap.step
            remotes.append(tss.RemotePieces(_addr(srv), entries))
        like = tckpt.template_state(st.params, tx)
        both = [e for r in remotes for e in r.entries()]
        assert tckpt.peer_coverage_ok(like, both)
        assert not tckpt.peer_coverage_ok(like, list(remotes[0].entries()))
        restored = tckpt.load_from_pieces(snap.step, like, tx,
                                          remotes=remotes, device="cpu")
        assert sum(r.fetched_bytes() for r in remotes) == sum(
            a.nbytes for ps in snap.pieces.values() for _, a in ps)
    finally:
        for r in remotes:
            r.close()
        for srv in servers:
            srv.close()
    _assert_states_equal(from_disk, restored)
    _assert_states_equal(st, restored)
    # the next step of each is the same step
    step = ttrainer.make_train_step(ctr.loss_fn, tx)
    b = ttrainer.global_batch(
        ctr.synthetic_batch(np.random.RandomState(5), 16, vocab=64),
        device="cpu")
    _assert_states_equal(step(from_disk, b)[0], step(restored, b)[0])


# -- the restore plane on the native coordinator ------------------------------


@pytest.fixture(scope="module")
def coord():
    with tcoord.CoordinatorServer(member_ttl_s=30.0) as s:
        yield s


def _plane(job, timeout_s, snap=None):
    cfg = SimpleNamespace(job=job, worker_id="w1", p2p=True,
                          rendezvous_timeout_s=timeout_s, p2p_linger_s=0.0)
    return P2PRestorePlane(cfg, lambda *p: "/".join((job,) + p), EpochKeyGC(),
                           lambda: snap)


def _two_members(coord, job):
    cl = coord.client()
    cl.register(f"{job}0", 1)
    cl.register(f"{job}1", 1)
    return cl, [m for m in cl.members() if m.name.startswith(job)]


def test_restore_times_out_when_rank0_never_decides(coord):
    cl, members = _two_members(coord, "ta")
    plane = _plane("ta", timeout_s=0.4)
    t0 = time.monotonic()
    with pytest.raises(TimeoutError, match="no restore decision"):
        plane.restore(cl, cl.epoch(), 1, members, None, None, None, None)
    assert 0.3 <= time.monotonic() - t0 < 5.0
    for m in members:
        cl.leave(m.name)
    cl.close()


@pytest.mark.parametrize("event,match", [
    ("rank0 leaves", "rank-0 worker died"),
    ("a member joins", "membership moved"),
])
def test_restore_bails_fast_when_rank0_dies_or_the_epoch_moves(coord, event,
                                                               match):
    job = "tb" if event == "rank0 leaves" else "tc"
    cl, members = _two_members(coord, job)
    rank0 = min(members, key=lambda m: m.rank)
    epoch = cl.epoch()
    members = [dict(vars(m), rank=0 if m is rank0 else 1) for m in members]
    members = [SimpleNamespace(**m) for m in members]
    if event == "rank0 leaves":
        cl.leave(rank0.name)
    else:
        cl.register(f"{job}2", 1)
    plane = _plane(job, timeout_s=30.0)
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match=match):
        plane.restore(cl, epoch, 1, members, None, None, None, None)
    assert time.monotonic() - t0 < 5.0
    for m in cl.members():
        if m.name.startswith(job):
            cl.leave(m.name)
    cl.close()


def test_rank0_decides_p2p_from_a_peer_and_vetoes_expire(coord, tmp_path):
    """Rank 0 (no RAM of its own) probes the roster, finds the peer's
    snapshot that tiles the state, publishes ``p2p:<step>`` (also under
    ``restore_last``) and restores it; a vetoed step falls through to
    ``none``. The per-step veto's TTL is the reference's."""
    st, tx = _ctr_state()
    snap = tckpt.snapshot_local(st)
    peer_cfg = SimpleNamespace(job="td", worker_id="td1", p2p=True,
                               rendezvous_timeout_s=5.0, p2p_linger_s=0.0)
    peer = P2PRestorePlane(peer_cfg, lambda *p: "/".join(("td",) + p),
                           EpochKeyGC(), lambda: snap)
    cl = coord.client()
    peer.start(cl)
    me_cfg = SimpleNamespace(job="td", worker_id="td0", p2p=True,
                             rendezvous_timeout_s=5.0, p2p_linger_s=0.0)
    me = P2PRestorePlane(me_cfg, lambda *p: "/".join(("td",) + p),
                         EpochKeyGC(), lambda: None)
    me.start(cl)
    try:
        cl.kv_put("td/shardsrv_names", '["td1"]')
        members = [SimpleNamespace(name="td0", rank=0)]
        like = tckpt.template_state(st.params, tx)
        got = me.restore(cl, 1, 0, members, like, tx, None, None,
                         device="cpu")
        assert cl.kv_get("td/restore_last") == f"p2p:{snap.step}"
        _assert_states_equal(st, got)
        cl.kv_put(f"td/p2p_veto/{snap.step}", "2")
        assert me.restore(cl, 3, 0, members, like, tx, None, None,
                          device="cpu") is None
        assert cl.kv_get("td/restore_last") == "none"
    finally:
        peer.server.close()
        me.server.close()
        cl.close()
    assert _veto_active("3", epoch=3)
    assert _veto_active("3", epoch=3 + _VETO_TTL_EPOCHS)
    assert not _veto_active("3", epoch=4 + _VETO_TTL_EPOCHS)
    assert not _veto_active(None, 1) and not _veto_active("garbage", 1)
