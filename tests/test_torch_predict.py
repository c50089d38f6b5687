"""Port parity of the export write side, ``runtime/predict`` and the
``predict`` verb: edl_tpu_torch's against edl_tpu's.

Exports pass both ways (the port writes, the reference reads, and the
reverse) under bf16, f32 and ``"none"``, equal array for array. Scoring
a reference-written export: CTR probabilities within 1e-5 and the AUC
equal; ResNet classes, BERT predictions and masked accuracy, and llama
and moe next tokens equal; their perplexity within 1e-5 relative (the f32
forwards agree to ~1e-6; argmax ties do not occur at these seeds). The
verb prints the reference verb's summary line and writes the same
``--out`` arrays.
"""

import os
import subprocess
import sys

import jax
import ml_dtypes
import numpy as np
import pytest
import torch

import chip_smoke
from edl_tpu.cli.main import main as jmain
from edl_tpu.models import bert as jb
from edl_tpu.models import ctr as jctr
from edl_tpu.models import llama as jl
from edl_tpu.models import moe as jmoe
from edl_tpu.models import resnet as jr
from edl_tpu.runtime import export as jexport
from edl_tpu.runtime import predict as jpred
from edl_tpu_torch import cli as tcli
from edl_tpu_torch.models import bert as tb
from edl_tpu_torch.models import resnet as tr
from edl_tpu_torch.models.convert import params_from_numpy
from edl_tpu_torch.runtime import export as texport
from edl_tpu_torch.runtime import predict as tpred

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROB_TOL = dict(rtol=1e-5, atol=1e-5)
PPL_RTOL = 1e-5


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _flat(tree):
    """{leaf path: float64 array} of a nested dict/list tree of arrays or
    tensors."""
    out = {}

    def walk(node, prefix):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, f"{prefix}/{k}" if prefix else k)
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, f"{prefix}/{i}" if prefix else str(i))
        else:
            if isinstance(node, torch.Tensor):
                out[prefix] = (node.detach().float().numpy(), str(node.dtype))
            else:
                a = np.asarray(node)
                out[prefix] = (a.astype(np.float32), a.dtype.name)
    walk(tree, "")
    return out


RES_CFG = jr.ResNetConfig.tiny(num_classes=7)
RES_JP = jr.init_params(jax.random.PRNGKey(1), RES_CFG)


# -- export both ways ----------------------------------------------------------


@pytest.mark.parametrize("dtype", ["bfloat16", "float32", "none"])
def test_port_export_loads_in_the_reference_and_back(dtype, tmp_path):
    """The port writes a ResNet tree (list-of-list stages, f32 leaves,
    an int leaf), the reference reads it; the reference writes the same
    tree, the port reads it: equal values, dtypes and manifests."""
    tp = params_from_numpy(_np(RES_JP), "cpu")
    tp["step_count"] = torch.arange(3, dtype=torch.int32)
    jp = dict(_np(RES_JP), step_count=np.arange(3, dtype=np.int32))
    texport.export_params(str(tmp_path / "t"), tp, 4, dtype=dtype,
                          model_meta=tr.ResNetConfig.tiny(7).to_meta())
    jexport.export_params(str(tmp_path / "j"), jp, 4, dtype=dtype,
                          model_meta=RES_CFG.to_meta())
    j_of_t, jdoc = jexport.load_export(str(tmp_path / "t"))
    t_of_j, tdoc = texport.load_export(str(tmp_path / "j"), device="cpu")
    _, jjdoc = jexport.load_export(str(tmp_path / "j"))
    for doc in (jdoc, tdoc):
        assert {k: v for k, v in doc.items() if k not in ("_dir", "source")} \
            == {k: v for k, v in jjdoc.items() if k not in ("_dir", "source")}
    a, b = _flat(j_of_t), _flat(t_of_j)
    assert a.keys() == b.keys() == _flat(jp).keys()
    want_name = {"bfloat16": "bfloat16", "float32": "float32",
                 "none": "float32"}[dtype]
    for k in a:
        np.testing.assert_array_equal(a[k][0], b[k][0])
        if k != "step_count":
            assert a[k][1] == want_name and b[k][1] == f"torch.{want_name}"
    assert a["step_count"][1] == "int32"
    # bit for bit: the port's bf16 cast is the reference's (round to
    # nearest even)
    if dtype == "bfloat16":
        got = np.asarray(j_of_t["stem"]).view(np.uint16)
        want = _np(RES_JP)["stem"].astype(ml_dtypes.bfloat16).view(np.uint16)
        np.testing.assert_array_equal(got, want)


def test_latest_pointer_never_regresses_and_gc_keeps_two(tmp_path):
    root = str(tmp_path)
    w = {"w": torch.ones(4, 4)}
    texport.export_params(root, w, 5)
    texport.export_params(root, {"w": 2 * torch.ones(4, 4)}, 9)
    assert texport.export_status(root)["step"] == 9
    # a stalled writer finishing late must NOT move the pointer back
    texport.export_params(root, w, 7)
    params, doc = texport.load_export(root, device="cpu")
    assert doc["step"] == 9 and float(params["w"][0, 0]) == 2.0
    for s in (10, 11, 12, 13):
        texport.export_params(root, w, s)
    dirs = sorted(d for d in os.listdir(root) if d.startswith("step-"))
    assert dirs == ["step-00000012", "step-00000013"]
    assert texport.export_status(root)["step"] == 13
    # the reference reads the port's pointer the same way
    assert jexport.export_status(root)["step"] == 13


def test_sharded_export_paths_raise_not_ported(tmp_path):
    with pytest.raises(NotImplementedError, match="not ported yet"):
        texport.export_from_checkpoint(str(tmp_path), str(tmp_path / "e"))
    with pytest.raises(NotImplementedError, match="not ported yet"):
        texport.load_export_sharded(str(tmp_path), None, {})


# -- predict_batch against the reference -------------------------------------


def _export(tmp_path, params, meta, dtype="none"):
    jexport.export_params(str(tmp_path), params, step=3, dtype=dtype,
                          model_meta=meta)
    jparams, jdoc = jpred.load_params_for_predict(str(tmp_path))
    tparams, tdoc = tpred.load_params_for_predict(str(tmp_path), device="cpu")
    return jparams, jdoc, tparams, tdoc


@pytest.mark.parametrize("dtype", ["none", "bfloat16"])
def test_predict_ctr_matches(tmp_path, dtype):
    vocab = 512
    jp = jctr.init_params(jax.random.PRNGKey(0), vocab=vocab, emb=8)
    meta = {"family": "ctr", "vocab": vocab, "emb": 8,
            "mlp_dims": list(jctr.MLP_DIMS)}
    jparams, jdoc, tparams, tdoc = _export(tmp_path, jp, meta, dtype)
    rows = jctr.synthetic_batch(np.random.RandomState(0), 150, vocab=vocab)
    want = jpred.predict_batch(jparams, jdoc, rows)
    got = tpred.predict_batch(tparams, tdoc, rows)
    assert got.keys() == want.keys() == {"prob", "auc"}
    np.testing.assert_allclose(got["prob"], want["prob"], **PROB_TOL)
    assert got["auc"] == want["auc"]
    no_label = tpred.predict_batch(
        tparams, tdoc, {k: rows[k] for k in ("dense", "sparse")})
    assert set(no_label) == {"prob"}


def test_predict_resnet_matches(tmp_path):
    jparams, jdoc, tparams, tdoc = _export(tmp_path, RES_JP,
                                           RES_CFG.to_meta())
    rows = jr.synthetic_batch(np.random.RandomState(0), 70, size=16,
                              num_classes=7)
    want = jpred.predict_batch(jparams, jdoc, rows)
    got = tpred.predict_batch(tparams, tdoc, rows)
    assert got.keys() == want.keys() == {"class", "acc"}
    assert got["class"].dtype == want["class"].dtype
    np.testing.assert_array_equal(got["class"], want["class"])
    assert got["acc"] == want["acc"]


def test_predict_bert_matches(tmp_path):
    cfg = jb.BertConfig.tiny(vocab=128)
    jp = jb.init_params(jax.random.PRNGKey(2), cfg)
    jparams, jdoc, tparams, tdoc = _export(tmp_path, jp, cfg.to_meta())
    rows = jb.synthetic_mlm_batch(np.random.RandomState(0), 70, 12, 128)
    want = jpred.predict_batch(jparams, jdoc, rows)
    got = tpred.predict_batch(tparams, tdoc, rows)
    assert got.keys() == want.keys() == {"pred", "masked_acc"}
    np.testing.assert_array_equal(got["pred"], want["pred"])
    assert got["masked_acc"] == want["masked_acc"]
    got = tpred.predict_batch(tparams, tdoc, {"tokens": rows["tokens"]})
    assert set(got) == {"pred"}


@pytest.mark.parametrize("t", [10, 1])
def test_predict_llama_matches(tmp_path, t):
    cfg = jl.LlamaConfig.tiny(vocab=128)
    jp = jl.init_params(jax.random.PRNGKey(3), cfg)
    jparams, jdoc, tparams, tdoc = _export(tmp_path, jp, cfg.to_meta())
    toks = np.random.RandomState(0).randint(0, 128, (70, t)).astype(np.int32)
    want = jpred.predict_batch(jparams, jdoc, {"tokens": toks})
    got = tpred.predict_batch(tparams, tdoc, {"tokens": toks})
    assert got.keys() == want.keys()
    np.testing.assert_array_equal(got["next_token"], want["next_token"])
    if t > 1:
        np.testing.assert_allclose(got["ppl"], want["ppl"], rtol=PPL_RTOL)
    else:
        assert "ppl" not in got


def _error(fn):
    with pytest.raises(Exception) as e:
        fn()
    return type(e.value), str(e.value)


def test_predict_errors_are_the_references(tmp_path):
    jexport.export_params(str(tmp_path / "bare"),
                          {"w": np.ones((2, 2), np.float32)}, step=1,
                          dtype="none")
    jp, jdoc = jpred.load_params_for_predict(str(tmp_path / "bare"))
    tp, tdoc = tpred.load_params_for_predict(str(tmp_path / "bare"),
                                             device="cpu")
    rows = {"tokens": np.zeros((1, 2), np.int32)}
    assert _error(lambda: tpred.predict_batch(tp, tdoc, rows)) == \
        _error(lambda: jpred.predict_batch(jp, jdoc, rows))
    jparams, jdoc, tparams, tdoc = _export(tmp_path / "r", RES_JP,
                                           RES_CFG.to_meta())
    for bad in ({"label": np.zeros(2)}, {}):
        got = _error(lambda: tpred.predict_batch(tparams, tdoc, bad))
        assert got == _error(lambda: jpred.predict_batch(jparams, jdoc, bad))
        assert got[0] is ValueError and "missing ['images']" in got[1]
    assert _error(lambda: tpred.load_rows()) == _error(lambda: jpred.load_rows())
    assert _error(lambda: tpred.load_rows("a", "b")) == \
        _error(lambda: jpred.load_rows("a", "b"))


@pytest.mark.parametrize("t", [10, 1])
def test_predict_moe_matches(tmp_path, t, capsys):
    """A tiny moe export (the reference's weights, f32) scored by
    ``predict_batch`` and by the verb: next tokens equal and ppl within
    1e-5 relative of the reference's, over 70 rows (two chunks of
    ``evals.CHUNK``: each chunk routes its own tokens, so the capacity
    is the chunk's), and the verb's summary line and ``--out`` arrays
    the reference verb's."""
    cfg = jmoe.MoEConfig.tiny(vocab=128)
    jp = jmoe.init_params(jax.random.PRNGKey(4), cfg)
    jparams, jdoc, tparams, tdoc = _export(tmp_path / "export", jp,
                                           cfg.to_meta())
    toks = np.random.RandomState(0).randint(0, 128, (70, t)).astype(np.int32)
    want = jpred.predict_batch(jparams, jdoc, {"tokens": toks})
    got = tpred.predict_batch(tparams, tdoc, {"tokens": toks})
    assert got.keys() == want.keys() == ({"next_token", "ppl"} if t > 1
                                         else {"next_token"})
    np.testing.assert_array_equal(got["next_token"], want["next_token"])
    if t > 1:
        np.testing.assert_allclose(got["ppl"], want["ppl"], rtol=PPL_RTOL)
    np.savez(tmp_path / "rows.npz", tokens=toks)
    argv = ["predict", str(tmp_path / "export"), "--input",
            str(tmp_path / "rows.npz")]
    assert jmain(argv + ["--out", str(tmp_path / "j.npz")]) == 0
    want_out = capsys.readouterr().out
    assert tcli.main(argv + ["--out", str(tmp_path / "t.npz"),
                             "--device", "cpu"]) == 0
    got_out = capsys.readouterr().out
    assert got_out.splitlines()[0].startswith(
        "predicted 70 rows (family=moe, step=3)")
    if t > 1:  # ppl printed to 6 digits: equal within PPL_RTOL
        g, w = (float(o.splitlines()[0].rsplit("ppl=", 1)[1])
                for o in (got_out, want_out))
        np.testing.assert_allclose(g, w, rtol=PPL_RTOL)
    else:
        assert got_out.splitlines()[0] == want_out.splitlines()[0]
    with np.load(tmp_path / "j.npz") as j, np.load(tmp_path / "t.npz") as z:
        assert sorted(j.files) == sorted(z.files) == ["next_token"]
        np.testing.assert_array_equal(z["next_token"], j["next_token"])


def test_unported_paths_say_not_ported_yet(tmp_path):
    with pytest.raises(NotImplementedError, match="not ported yet"):
        tpred.load_params_for_predict(str(tmp_path), "fsdp=4")
    with pytest.raises(NotImplementedError, match="not ported yet"):
        tpred.load_rows(data_dir=str(tmp_path))


# -- the verb --------------------------------------------------------------------


def _verb_setup(tmp_path):
    cfg = jb.BertConfig.tiny(vocab=128)
    jp = jb.init_params(jax.random.PRNGKey(2), cfg)
    jexport.export_params(str(tmp_path / "export"), jp, step=5, dtype="none",
                          model_meta=cfg.to_meta())
    rows = jb.synthetic_mlm_batch(np.random.RandomState(0), 20, 12, 128)
    np.savez(tmp_path / "rows.npz", **rows)
    return str(tmp_path / "export"), str(tmp_path / "rows.npz")


def test_cli_predict_prints_the_reference_summary(tmp_path, capsys):
    export_dir, rows = _verb_setup(tmp_path)
    argv = ["predict", export_dir, "--input", rows]
    assert jmain(argv + ["--out", str(tmp_path / "j.npz")]) == 0
    want = capsys.readouterr().out
    assert tcli.main(argv + ["--out", str(tmp_path / "t.npz"),
                             "--device", "cpu"]) == 0
    got = capsys.readouterr().out
    assert got.splitlines()[0] == want.splitlines()[0]
    assert got.splitlines()[0].startswith(
        "predicted 20 rows (family=bert, step=5) masked_acc=")
    with np.load(tmp_path / "j.npz") as j, np.load(tmp_path / "t.npz") as t:
        assert sorted(j.files) == sorted(t.files) == ["pred"]
        np.testing.assert_array_equal(t["pred"], j["pred"])
    # without --out: the heads of the per-row outputs, as the reference
    assert jmain(argv) == 0
    want = capsys.readouterr().out
    assert tcli.main(argv + ["--device", "cpu"]) == 0
    assert capsys.readouterr().out == want


def test_cli_predict_errors(tmp_path, capsys):
    export_dir, rows = _verb_setup(tmp_path)
    cases = {
        "--mesh": (["predict", export_dir, "--input", rows, "--mesh",
                    "fsdp=4"], "--mesh is not ported yet"),
        "--data-dir": (["predict", export_dir, "--data-dir", str(tmp_path)],
                       "--data-dir is not ported yet"),
        "no input": (["predict", export_dir], "bad input: give exactly one"),
        "no export": (["predict", str(tmp_path / "none"), "--input", rows],
                      "no published export"),
    }
    for name, (argv, msg) in cases.items():
        assert tcli.main(argv + ["--device", "cpu"]) == 1, name
        assert msg in capsys.readouterr().err, name
    # the same messages and codes as the reference where both run
    for argv in (cases["no input"][0], cases["no export"][0]):
        assert jmain(argv) == 1
        want = capsys.readouterr().err
        assert tcli.main(argv + ["--device", "cpu"]) == 1
        assert capsys.readouterr().err == want
    # a moe export without the model's leaves: the forward's KeyError
    # escapes both verbs alike (a process exits 1 with its traceback)
    jexport.export_params(str(tmp_path / "moe"),
                          {"w": np.ones((2, 2), np.float32)}, step=1,
                          dtype="none", model_meta={"family": "moe"})
    argv = ["predict", str(tmp_path / "moe"), "--input", rows]
    got = _error(lambda: tcli.main(argv + ["--device", "cpu"]))
    assert got == _error(lambda: jmain(argv)) == (KeyError, "'embed'")


def test_python_m_edl_tpu_torch_predict(tmp_path):
    """The verb as a consumer runs it: a subprocess on the CPU."""
    export_dir, rows = _verb_setup(tmp_path)
    out = tmp_path / "scored.npz"
    r = subprocess.run(
        [sys.executable, "-m", "edl_tpu_torch", "predict", export_dir,
         "--input", rows, "--out", str(out), "--device", "cpu"],
        capture_output=True, text=True, timeout=240, cwd=ROOT)
    assert r.returncode == 0, r.stderr
    assert "family=bert" in r.stdout and f"outputs -> {out}" in r.stdout
    with np.load(out) as z:
        assert z["pred"].shape == (20, 12)


# -- chip_smoke's export gate ----------------------------------------------------


def _tiny_resnet_params():
    return tr.init_params(torch.Generator().manual_seed(0),
                          tr.ResNetConfig.tiny(), device="cpu")


def test_chip_smoke_export_roundtrip_holds_on_the_cpu(tmp_path):
    params = _tiny_resnet_params()
    meta = tr.ResNetConfig.tiny().to_meta()
    loaded, doc, _, _ = chip_smoke._export_roundtrip(str(tmp_path), params,
                                                     meta)
    assert doc["model"] == meta and doc["dtype"] == "bfloat16"
    out = tpred.predict_batch(loaded, doc, tr.synthetic_batch(
        np.random.RandomState(0), 5))
    assert out["class"].shape == (5,)


def test_chip_smoke_export_gate_trips_on_a_half_written_export(
        tmp_path, monkeypatch):
    """``latest`` published before the step directory is whole: the
    gate raises instead of scoring a torn export."""

    def torn(root, params, step, dtype="bfloat16", source="", model_meta=None):
        d = os.path.join(root, f"step-{step:08d}")
        os.makedirs(d, exist_ok=True)
        with open(os.path.join(d, "params.npz.tmp"), "wb") as f:
            f.write(b"PK")
        with open(os.path.join(root, "latest"), "w") as f:
            f.write(os.path.basename(d))
        return d

    monkeypatch.setattr(texport, "export_params", torn)
    with pytest.raises(AssertionError, match="does not load"):
        chip_smoke._export_roundtrip(str(tmp_path), _tiny_resnet_params(),
                                     tr.ResNetConfig.tiny().to_meta())


def test_chip_smoke_export_gate_trips_on_a_wrong_cast(tmp_path, monkeypatch):
    """An export that truncates instead of rounding to bf16 is not the
    trained params cast to bf16."""
    def truncating(t, dtype):
        if dtype == "bfloat16" and t.dtype == torch.float32:
            bits = t.view(torch.int32) & -65536
            return bits.view(torch.float32).to(torch.bfloat16)
        return t

    monkeypatch.setattr(texport, "_cast", truncating)
    with pytest.raises(AssertionError, match="not the bf16 params"):
        chip_smoke._export_roundtrip(str(tmp_path), _tiny_resnet_params(),
                                     tr.ResNetConfig.tiny().to_meta())


def test_predict_bf16_export_of_bert_runs(tmp_path):
    """A bf16 export (the default) scores under the config's f32
    compute: the weights enter at their stored values."""
    cfg = tb.BertConfig.tiny(vocab=64)
    params = tb.init_params(torch.Generator().manual_seed(0), cfg,
                            device="cpu")
    texport.export_params(str(tmp_path), params, 2, model_meta=cfg.to_meta())
    loaded, doc = tpred.load_params_for_predict(str(tmp_path), device="cpu")
    assert loaded["embed"].dtype == torch.bfloat16
    rows = tb.synthetic_mlm_batch(np.random.RandomState(0), 3, 8, 64)
    out = tpred.predict_batch(loaded, doc, rows)
    assert out["pred"].shape == (3, 8) and 0.0 <= out["masked_acc"] <= 1.0
