"""The port's run_metrics CLI on the CPU (moved out of
test_torch_metrics.py, whose 16 px snapshot fixture it uses, so that
``--dist loadfile`` runs it on a worker of its own): a run on a 16 px
snapshot, the refusals before anything loads, and the weights routed as the
JAX CLI routes them."""

import os

import numpy as np
import pytest

from inclusivegan_torch import run_metrics
from inclusivegan_torch.metrics import metric_base as tmb
from inclusivegan_torch.metrics.metric_defaults import metric_defaults
from inclusivegan_torch.utils.easydict import EasyDict
from inclusivegan_torch.utils.run_harness import SubmitConfig
from test_torch_metrics import snapshot_16px  # noqa: F401
from test_torch_training_loop import toy_dataset  # noqa: F401


def test_run_metrics_cli_on_a_16px_snapshot(snapshot_16px, toy_dataset, tmp_path,  # noqa: F811
                                            monkeypatch):
    """``python -m inclusivegan_torch.run_metrics`` with dummy and FID (the
    registry's fid10k cut to 16 images) on the CPU: a run dir with one line
    per metric, FID finite and tagged _random_features."""
    monkeypatch.setenv("INCLUSIVEGAN_CACHE", str(tmp_path / "cache"))
    monkeypatch.setitem(metric_defaults, "fid10k",
                        EasyDict(metric_defaults["fid10k"], num_images=16))
    results = run_metrics.main([
        "--network", snapshot_16px, "--metrics", "dummy,fid10k",
        "--data-dir", os.path.dirname(toy_dataset), "--dataset",
        os.path.basename(toy_dataset), "--mirror-augment", "true",
        "--result-dir", str(tmp_path / "results"), "--device", "cpu"])
    assert results["dummy"] == 0.0 and np.isfinite(results["fid10k"])
    assert results["fid10k"] > 0 and results["fid10k_random_features"] == 1.0
    (run_dir,) = [os.path.join(tmp_path / "results", d)
                  for d in os.listdir(tmp_path / "results")]
    assert run_dir.endswith("-run_metrics")
    fid_lines = open(os.path.join(run_dir, "metric-fid10k.txt")).read().splitlines()
    assert len(fid_lines) == 1 and "fid10k_random_features 1" in fid_lines[0]
    assert "network-snapshot-000000" in fid_lines[0]
    assert len(open(os.path.join(run_dir, "metric-dummy.txt")).read().splitlines()) == 1
    log = open(os.path.join(run_dir, "log.txt")).read()
    assert "fid10k: Gs 16 images" in log and "fid10k: InceptionV3 16 images" in log


def test_run_metrics_cli_refuses_before_loading(tmp_path):
    """An unknown name, or more cards than are present (none here), raises
    before a run dir is made."""
    argv = ["--network", "missing.pkl", "--data-dir", str(tmp_path), "--dataset", "x",
            "--result-dir", str(tmp_path / "results")]
    with pytest.raises(ValueError, match="unknown metric"):
        run_metrics.main(argv + ["--metrics", "fid10k,pr50"])
    with pytest.raises(RuntimeError, match="2 ranks need 2 CUDA cards, and 0 are present"):
        run_metrics.main(argv + ["--metrics", "pr50k3", "--num-gpus", "2"])
    assert not (tmp_path / "results").exists()


@pytest.mark.parametrize("name,lpips,classifier", [
    ("ppl_wend", True, False), ("ppl2_wend", True, False), ("mode_counts_24k", False, True),
    ("KL24k", False, True), ("ls", False, False), ("fid30k", False, False)])
def test_run_metrics_routes_weights_as_the_jax_cli(name, lpips, classifier, monkeypatch):
    """``--lpips-weights`` reaches the PPL metrics only, ``--classifier-weights``
    mode_counts and KL only, as the JAX package's ``run_metrics.run`` routes
    them."""
    seen = []
    monkeypatch.setattr(tmb, "run_metric", lambda args, **kw: seen.append(args) or {})
    run_metrics.run(SubmitConfig(run_dir="x"), "net.pkl", [metric_defaults[name]], "ds",
                    "dir", lpips_weights="l.npz", classifier_weights="c.npz", device="cpu")
    (args,) = seen
    assert args.get("lpips_weights") == ("l.npz" if lpips else None)
    assert args.get("classifier_weights") == ("c.npz" if classifier else None)
