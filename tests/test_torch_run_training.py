"""The port's training CLI against the JAX package's ``run_training.py``:
the same flags parse to the same ``run()`` keyword arguments, and ``run()``
submits the same loop arguments and run description; ``main`` switches TF32
off before anything loads; each knob that is not ported yet raises
``NotImplementedError`` before a run dir is made."""

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
    """The JAX CLI defaults to fid30k; the port to none, so that a run
    evaluates only the metrics it names."""
    kw = _main_kwargs(run_training, ["--data-dir", str(tmp_path), "--dataset", "x"],
                      monkeypatch)
    assert kw["metrics"] == []


def test_help_says_float32_and_metrics_none(capsys):
    with pytest.raises(SystemExit):
        run_training.main(["--help"])
    text = " ".join(capsys.readouterr().out.split())
    assert "TF32 is switched off" in text
    assert "none (default) or comma-separated registry names" in text
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


@pytest.mark.parametrize("flags,match", [
    (["--invariant-rng", "true"], "queue 1 item 4"),
    (["--knn-backend", "dci"], "queue 1 item 5"),
    (["--num-gpus", "2"], "queue 1 item 6"),
])
def test_unported_flags_raise_before_the_run(flags, match, monkeypatch, tmp_path):
    monkeypatch.setattr(run_training, "submit_run",
                        lambda *a, **k: pytest.fail("a run was submitted"))
    with pytest.raises(NotImplementedError, match=match):
        run_training.main(["--data-dir", str(tmp_path), "--dataset", "x"] + flags)
    assert not (tmp_path / "results").exists()


def test_vestigial_configs_rejected(tmp_path):
    with pytest.raises(SystemExit, match="vestigial"):
        run_training.main(["--data-dir", str(tmp_path), "--dataset", "x",
                           "--config", "config-b", "--result-dir", str(tmp_path)])
