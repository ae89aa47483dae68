"""The port's training CLI against the JAX package's ``run_training.py``:
the same flags parse to the same ``run()`` keyword arguments, and ``run()``
submits the same loop arguments and run description; ``main`` switches TF32
off before anything loads; ``--num-gpus`` over the cards present raises
before a run dir is made (the data-parallel runs themselves are in
``tests/test_torch_data_parallel.py``)."""

import sys

import pytest
import torch

import run_training as jax_run_training
from inclusivegan_torch import run_training

CELEBA_FLAGS = [  # scripts/run_celeba_quality_loop.sh, at float32
    "--config", "config-e-Gskip-Dresnet", "--num-gpus", "1", "--minibatch-gpu", "6",
    "--mirror-augment", "true", "--init-proj-dim", "512", "--candidate-batch-size",
    "1024", "--lpips-weights", "artifacts/celeba_perceptual_vgg.npz", "--data-size",
    "60", "--metrics", "none", "--smoke-test-max-iters", "4"]
OTHER_FLAGS = [
    "--config", "config-f", "--gamma", "5", "--init-staleness", "3", "--seed", "7",
    "--resume-pkl", "x_scratch.pkl", "--resume-checkpoint", "ck", "--total-kimg", "12",
    "--attr-interesting", "Male,Young", "--dist-thres-percentile", "90",
    "--exclusive-retrieved-code", "1", "--g-loss-batched", "false",
    "--image-snapshot-ticks", "2", "--network-snapshot-ticks", "5",
    "--enable-profiler", "true", "--knn-backend", "exact", "--lpips-norm", "f32",
    "--NN-rec-lpips-weight", "1.5", "--knn-perturb-factor", "0.1", "--init-mul", "0.5",
    "--metrics", "none"]


def _main_kwargs(module, argv, monkeypatch):
    seen = {}
    with monkeypatch.context() as m:
        m.setattr(module, "run", lambda **kw: seen.update(kw))
        m.setattr(sys, "argv", ["run_training.py"] + argv)
        module.main()
    return seen


def _run_submission(module, kwargs, monkeypatch):
    seen = {}

    def fake_submit(sc, fn, **kw):
        seen.update(sc=sc, fn=fn, kwargs=kw)

    monkeypatch.setattr(module, "submit_run", fake_submit)
    module.run(**kwargs)
    return seen


@pytest.mark.parametrize("flags", [CELEBA_FLAGS, OTHER_FLAGS], ids=["celeba", "other"])
def test_flags_parse_and_submit_like_the_jax_cli(flags, monkeypatch, tmp_path):
    argv = ["--data-dir", str(tmp_path), "--dataset", "celeba_synth",
            "--result-dir", str(tmp_path / "results")] + flags
    want = _main_kwargs(jax_run_training, argv, monkeypatch)
    got = _main_kwargs(run_training, argv, monkeypatch)
    assert got.pop("device") == "cuda"
    assert got == want

    sub_want = _run_submission(jax_run_training, want, monkeypatch)
    sub_got = _run_submission(run_training, dict(got, device="cpu"), monkeypatch)
    assert sub_got["fn"] == "inclusivegan_torch.training.training_loop.training_loop"
    assert sub_got["kwargs"].pop("device") == "cpu"
    assert sub_got["kwargs"] == sub_want["kwargs"]
    assert sub_got["sc"].run_desc == sub_want["sc"].run_desc
    assert sub_got["sc"].num_devices == sub_want["sc"].num_devices


def test_main_switches_tf32_off_before_the_run(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    seen = {}

    def fake_run(**kw):
        seen["flags"] = (torch.backends.cudnn.allow_tf32,
                         torch.backends.cuda.matmul.allow_tf32)

    monkeypatch.setattr(run_training, "run", fake_run)
    run_training.main(["--data-dir", str(tmp_path), "--dataset", "x"])
    assert seen["flags"] == (False, False)


def test_metrics_default_to_none(monkeypatch, tmp_path):
    """Without --metrics a run evaluates fid30k, as the JAX CLI's does;
    ``--metrics none`` evaluates nothing."""
    argv = ["--data-dir", str(tmp_path), "--dataset", "x"]
    assert _main_kwargs(run_training, argv, monkeypatch)["metrics"] == ["fid30k"]
    assert _main_kwargs(run_training, argv + ["--metrics", "none"],
                        monkeypatch)["metrics"] == []


def test_default_flags_give_the_jax_clis_run_kwargs(monkeypatch, tmp_path):
    """The required flags alone parse to the JAX CLI's ``run()`` keyword
    arguments, its default metric among them."""
    argv = ["--data-dir", str(tmp_path), "--dataset", "x"]
    want = _main_kwargs(jax_run_training, argv, monkeypatch)
    got = _main_kwargs(run_training, argv, monkeypatch)
    assert got.pop("device") == "cuda"
    assert got == want and want["metrics"] == ["fid30k"]


def test_help_says_float32_and_metrics_none(capsys):
    """The help names the default metric, fid30k, and ``none``."""
    with pytest.raises(SystemExit):
        run_training.main(["--help"])
    text = " ".join(capsys.readouterr().out.split())
    assert "TF32 is switched off" in text
    assert "comma-separated registry names (default fid30k) or none" in text
    assert "run at every network snapshot: mode_counts_24k, KL24k, fid30k" in text
    assert "activation dtype of G, D and the LPIPS trunk" in text


@pytest.mark.parametrize("metrics", ["fid30k,pr50k3", "ppl_wend,ls,mode_counts_24k,KL24k"])
def test_every_metric_reaches_the_loop(metrics, monkeypatch, tmp_path):
    """Every registry name is built before the run and handed to the loop
    at every network snapshot; an unknown one raises first."""
    seen = {}
    monkeypatch.setattr(run_training, "submit_run",
                        lambda sc, fn, **kw: seen.update(kw))
    run_training.main(["--data-dir", str(tmp_path), "--dataset", "x",
                       "--metrics", metrics])
    assert [m.name for m in seen["metric_arg_list"]] == metrics.split(",")
    with pytest.raises(ValueError, match="unknown metric"):
        run_training.main(["--data-dir", str(tmp_path), "--dataset", "x",
                           "--metrics", metrics + ",ppl"])


@pytest.mark.parametrize("flags,key,value", [
    (["--invariant-rng", "true"], "invariant_rng", True),
    (["--knn-backend", "dci"], "knn_backend", "dci"),
])
def test_invariant_rng_and_dci_flags_reach_the_loop(flags, key, value, monkeypatch,
                                                    tmp_path):
    """--invariant-rng and --knn-backend dci reach the loop's arguments, as
    the JAX CLI submits them."""
    argv = ["--data-dir", str(tmp_path), "--dataset", "x", "--metrics", "none"] + flags
    want = _run_submission(jax_run_training, _main_kwargs(jax_run_training, argv,
                                                          monkeypatch), monkeypatch)
    got = _run_submission(run_training, _main_kwargs(run_training, argv, monkeypatch),
                          monkeypatch)
    assert got["kwargs"][key] == want["kwargs"][key] == value
    assert got["kwargs"].pop("device") == "cuda"
    assert got["kwargs"] == want["kwargs"]


@pytest.mark.parametrize("flags,error,match", [
    (["--num-gpus", "2"], RuntimeError, "2 ranks need 2 CUDA cards, and 0 are present"),
    (["--num-gpus", "0"], ValueError, "at least one"),
    (["--device", "cuda:0", "--num-gpus", "2"], RuntimeError,
     "device 'cuda:0' names card 0, and 0 CUDA cards are present"),
])
def test_unported_flags_raise_before_the_run(flags, error, match, monkeypatch, tmp_path):
    """More cards than are present, or a named card that is not (none
    here), raise before a run dir is made: nothing moves to the CPU or to
    fewer ranks."""
    monkeypatch.setattr(run_training, "submit_run",
                        lambda *a, **k: pytest.fail("a run was submitted"))
    with pytest.raises(error, match=match):
        run_training.main(["--data-dir", str(tmp_path), "--dataset", "x",
                           "--result-dir", str(tmp_path / "results")] + flags)
    assert not (tmp_path / "results").exists()


def test_vestigial_configs_rejected(tmp_path):
    with pytest.raises(SystemExit, match="vestigial"):
        run_training.main(["--data-dir", str(tmp_path), "--dataset", "x",
                           "--config", "config-b", "--result-dir", str(tmp_path)])


def test_select_best_snapshot_reads_the_ports_metric_file(monkeypatch, tmp_path):
    """The repository's jax-free ``scripts/select_best_snapshot.py`` and
    ``scripts/record_quality_digest.py`` read the ``metric-fid30k.txt``
    lines that the port's ``MetricBase.run`` appends in a run dir at each
    network snapshot."""
    import json
    import os
    import subprocess

    from inclusivegan_torch.metrics import metric_base

    class Fixed(metric_base.MetricBase):
        def _evaluate(self, sampler, dataset_args, data_dir, value=None):
            self._report_result(value)

    class NoSampler:  # the metric reads no image
        rank = 0

        def __init__(self, *args, **kwargs):
            pass

        def close(self):
            pass

    monkeypatch.setattr(metric_base, "GsSampler", NoSampler)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    run_dir = tmp_path / "00000-stylegan2-celeba_synth-1dev"
    run_dir.mkdir()
    for kimg, fid in ((0, 40.5), (12, 8.25), (24, 9.75)):
        pkl = run_dir / f"network-snapshot-{kimg:06d}.pkl"
        pkl.write_bytes(b"")
        Fixed("fid30k").run(str(pkl), run_dir=str(run_dir), dataset_args={"tfrecord_dir": "x"},
                            device="cpu", value=fid)
    (run_dir / "network-final.pkl").write_bytes(b"")
    best = subprocess.run([sys.executable, os.path.join(root, "scripts", "select_best_snapshot.py"),
                           str(run_dir), "--metric", "fid30k"],
                          capture_output=True, text=True, check=True)
    assert best.stdout.strip() == str(run_dir / "network-snapshot-000012.pkl")
    digest = tmp_path / "digest.json"
    subprocess.run([sys.executable, os.path.join(root, "scripts", "record_quality_digest.py"),
                    str(run_dir), "--out", str(digest)], capture_output=True, check=True)
    records = json.loads(digest.read_text())["metrics"]["fid30k"]["records"]
    assert [(r["snapshot"], r["columns"]) for r in records] == [
        (f"network-snapshot-{k:06d}", {"fid30k": v})
        for k, v in ((0, 40.5), (12, 8.25), (24, 9.75))]
