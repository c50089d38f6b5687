"""The example twins (``edl_tpu_torch/examples``): each entry runs at a
small size on a pool of four CPU processes (``--device cpu``) and prints
the lines its reference prints; each manifest is its reference's
``job.yaml``; ``--real-data`` exits 1 naming its ROADMAP item."""

import os

import pytest
import torch

from edl_tpu_torch.api.job import TrainingJob
from edl_tpu_torch.examples import _pool
from edl_tpu_torch.examples.ctr import train as ctr_train
from edl_tpu_torch.examples.fit_a_line import train_ft
from edl_tpu_torch.examples.llama import train as llama_train
from edl_tpu_torch.examples.recognize_digits import train as digits_train

torch.set_num_threads(1)

EXAMPLES = os.path.join(os.path.dirname(__file__), os.pardir, "examples")
TWINS = {"fit_a_line": train_ft, "ctr": ctr_train,
         "recognize_digits": digits_train, "llama": llama_train}


@pytest.mark.parametrize("name", sorted(TWINS))
def test_each_manifest_is_the_references_job_yaml(name):
    want = TrainingJob.from_yaml_file(os.path.join(EXAMPLES, name,
                                                   "job.yaml"))
    assert TrainingJob.from_dict(TWINS[name].JOB) == want


def test_fit_a_line_survives_a_dead_worker(capsys):
    rc = train_ft.main(["--devices", "4", "--device", "cpu", "--samples",
                        "1024", "--chunk", "64", "--kill-one-worker"])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "submitted fit-a-line: workers start at 2" in out
    assert "dies (taking worker pod" in out
    done = [ln for ln in out.splitlines() if ln.startswith("done:")][0]
    assert "phase=succeeded" in done and "reshards=['2->4" in done
    assert "'4->3" in done


def test_ctr_grows_loses_a_host_and_drains(capsys, tmp_path):
    rc = ctr_train.main([
        "--devices", "4", "--device", "cpu", "--steps", "6", "--batch", "32",
        "--vocab", "2048", "--samples", "2048", "--passes", "1",
        "--kill-one-worker", "--drain", "--check-one-rank",
        "--data-dir", str(tmp_path / "shards"),
        "--export-dir", str(tmp_path / "export")])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "prepared 2048 rows of CTR data" in out
    trained = [ln for ln in out.splitlines() if ln.startswith("trained")][0]
    assert "on 3 workers" in trained and "(2, 4), (4, 3)" in trained
    line = out.split("max relative loss difference a step ")[1]
    a_step, over_run = line.split()[0], line.split("over the run ")[1]
    assert float(a_step.rstrip(",")) <= 1e-5
    assert float(over_run.split()[0]) <= 1e-5  # at this size, no drift
    assert "final export published" in out


def test_recognize_digits_keeps_its_fixed_workers(capsys):
    rc = digits_train.main(["--devices", "4", "--device", "cpu",
                            "--samples", "256", "--per-worker-batch", "8"])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "submitted recognize-digits: fixed 4 workers" in out
    assert "epoch 1: loss" in out
    assert "done: phase=succeeded workers=4 epochs=2" in out


@pytest.mark.parametrize("mesh", ["sp=2,dp", "pp=2,dp"])
def test_llama_trains_over_sp_and_pp(capsys, tmp_path, mesh):
    rc = llama_train.main(["--devices", "4", "--device", "cpu", "--steps",
                           "2", "--seq", "32", "--mesh", mesh,
                           "--export-dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert rc == 0, out
    axis = mesh.split("=")[0]
    assert f"mesh: {{'dp': 2, '{axis}': 2}}" in out
    assert "step 1: loss=" in out and "generated from export" in out
    assert out.rstrip().endswith("ok")


@pytest.mark.parametrize("twin", [ctr_train, digits_train],
                         ids=["ctr", "recognize_digits"])
def test_real_data_exits_one_naming_its_item(capsys, twin):
    assert twin.main(["--real-data", "--device", "cpu"]) == 1
    err = capsys.readouterr().err
    assert f"item {_pool.REAL_DATA_ITEM}" in err
