"""The stacked-MNIST experiment's script, host tools and shell scripts
through the port, on the CPU and without training.

- ``python -m inclusivegan_torch.scripts.exp_stacked_mode_coverage`` parses
  the JAX script's flags to the JAX script's ``submit_run`` arguments (the
  dtype as torch's, ``device`` added), and runs as a file from any
  directory, as the watchdog launches it.
- Run dirs written by the port: module 1's own ``submit_run`` (its
  ``submit_config.txt`` and run-dir name) around a stand-in loop that writes,
  through the port's writers, what the loop writes at its network
  snapshots (``snapshot_dict``, ``save_checkpoint``, ``mode_counts_24k``'s
  line through ``MetricBase.run`` with the modes handed in).
- ``scripts/watchdog_mode_coverage.py``, unchanged, with a stub
  ``--exp-script``: its crash and collapse relaunches read such a run dir
  and give the resume arguments of its ``relaunch`` (``--resume-checkpoint``
  with ``--resume-staleness 1``, or ``--resume-pkl`` with the rampup), which
  module 1 parses.
- ``scripts/mirror_best_checkpoint.py --once`` and
  ``scripts/restore_best_weights.py``, unchanged, on such a run dir: the
  fp16 mirror and its stamp, the backed-up checkpoint loading in the port,
  the restored snapshot read by the port's ``load_snapshot`` equal to the
  snapshot after an fp16 round trip, the stub ``log.txt`` read by
  ``misc.parse_kimg_time_from_log``; then the port's ``eval_artifact
  --record-only`` on a port ``run_metrics`` dir of the restored snapshot.
- ``python -m inclusivegan_torch.scripts.bench_dci_build`` at 512-2048
  points of dimension 16.
- Each shell script of ``scripts/`` and its port in
  ``inclusivegan_torch/scripts/``, run from a copy of both in a temporary
  tree with stub executables first on ``PATH`` (``python3``, ``git`` and the
  file commands) that log their arguments and touch nothing: the port's
  command sequence is the JAX script's under the module mapping, with
  identical arguments.
"""

import builtins
import hashlib
import importlib.util
import json
import os
import pickle
import re
import shutil
import stat
import subprocess
import sys
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from inclusivegan_torch.metrics import mode_counts as tmc
from inclusivegan_torch.metrics.metric_base import run_metric
from inclusivegan_torch.models.stylegan2 import Discriminator, GMain
from inclusivegan_torch.scripts import exp_stacked_mode_coverage as exp
from inclusivegan_torch.snapshot import snapshot_dict
from inclusivegan_torch.training.checkpoint import save_checkpoint
from inclusivegan_torch.training.train_state import create_train_state
from inclusivegan_torch.utils import misc, run_harness

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MNIST_NPZ = os.path.join(ROOT, "metrics_weights", "stacked_mnist_classifier.npz")
STUB_LOOP = "test_torch_experiment_tools.stub_loop"


def _tool(name):
    """``scripts/<name>.py`` loaded as a module, unchanged."""
    spec = importlib.util.spec_from_file_location(
        f"_tool_{name}", os.path.join(ROOT, "scripts", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


# ---------------------------------------------------------------------------
# Module 1 against the JAX script.

EVERY_FLAG = [
    "--data-dir", "d", "--dataset", "stacked_synth_60k", "--data-size", "59904",
    "--classifier", "c.npz", "--result-root", "res", "--num-epochs", "2", "--minibatch",
    "128", "--num-samples-factor", "4", "--init-proj-dim", "0", "--candidate-batch-size",
    "2048", "--smoke", "3", "--image-snapshot-ticks", "10", "--network-snapshot-ticks", "2",
    "--resume-checkpoint", "ck", "--resume-pkl", "snap.pkl", "--resume-rampup-kimg", "40",
    "--resume-g-from-gs", "--resume-staleness", "1", "--g-lrate", "0.004", "--d-lrate",
    "0.001", "--gamma", "50", "--rec-weight", "4", "--rec-weight-final", "6",
    "--rec-weight-ramp-start", "10", "--rec-weight-ramp-end", "90",
    "--exclusive-retrieved-code", "1", "--seed", "3000", "--lpips-weights", "p.npz",
    "--dtype", "float32", "--g-loss-batched", "0", "--ema-kimg", "20"]


def _captured(main, argv, module, monkeypatch):
    seen = {}
    with monkeypatch.context() as m:
        m.setattr(module, "submit_run", lambda sc, fn, **kw: seen.update(sc=sc, fn=fn, kw=kw))
        main(argv)
    return seen


def _jax_main(argv):
    tool = _tool("exp_stacked_mode_coverage")
    with pytest.MonkeyPatch.context() as m:
        import inclusivegan_tpu.utils.compilation_cache as cache
        m.setattr(cache, "enable_compilation_cache", lambda *a, **k: None)
        m.setattr(sys, "argv", ["exp_stacked_mode_coverage.py"] + argv)
        tool.main()


def _comparable(kw, dtype_name):
    out = dict(kw)
    for net in ("G_args", "D_args"):
        out[net] = dict(kw[net], dtype=dtype_name(kw[net]["dtype"]))
    out["metric_arg_list"] = [dict(m, func_name=m["func_name"].rsplit(".metrics.", 1)[1])
                              for m in kw["metric_arg_list"]]
    return out


@pytest.mark.parametrize("argv", [[], EVERY_FLAG], ids=["defaults", "every_flag"])
def test_exp_script_submits_the_jax_scripts_arguments(argv, monkeypatch):
    """The same flags give the same loop arguments, run description and
    device count; the dtype is torch's and the port adds ``device``."""
    import inclusivegan_tpu.utils.run_harness as jax_harness
    want = _captured(lambda a: _jax_main(a), argv, jax_harness, monkeypatch)
    got = _captured(exp.main, argv + ["--device", "cpu"], run_harness, monkeypatch)
    assert want["fn"] == "inclusivegan_tpu.training.training_loop.training_loop"
    assert got["fn"] == "inclusivegan_torch.training.training_loop.training_loop"
    assert got["kw"].pop("device") == "cpu"
    assert isinstance(got["kw"]["G_args"]["dtype"], torch.dtype)
    assert _comparable(got["kw"], lambda d: str(d).rsplit(".", 1)[1]) == \
        _comparable(want["kw"], lambda d: np.dtype(d).name)
    for key in ("run_desc", "run_dir_root", "num_devices"):
        assert got["sc"][key] == want["sc"][key], key


def test_exp_script_runs_as_a_file_from_any_directory(tmp_path):
    """``python <repo>/inclusivegan_torch/scripts/exp_stacked_mode_coverage.py``
    from another directory reaches the port's loop, which stops at the
    missing dataset inside its run dir."""
    script = os.path.join(ROOT, "inclusivegan_torch", "scripts",
                          "exp_stacked_mode_coverage.py")
    proc = subprocess.run([sys.executable, script, "--device", "cpu", "--data-dir",
                           str(tmp_path / "none"), "--result-root", str(tmp_path / "res")],
                          cwd=str(tmp_path), capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    (run_dir,) = os.listdir(tmp_path / "res")
    assert run_dir == "00000-stacked-synth-16k-mode-coverage"
    names = os.listdir(tmp_path / "res" / run_dir)
    assert "_finished.txt" in names and any(n.endswith("-error.txt") for n in names)
    log = (tmp_path / "res" / run_dir / "log.txt").read_text()
    assert "Running inclusivegan_torch.training.training_loop.training_loop()" in log


# ---------------------------------------------------------------------------
# Run dirs written by the port.

STUB = {}  # the stand-in loop's evaluations [(cur_nimg, modes)] and whether it crashes


def _narrow_state():
    G = GMain.create(resolution=32, latent_size=16, dlatent_size=16, mapping_layers=2,
                     mapping_fmaps=16, fmap_base=128, fmap_max=16)
    D = Discriminator(resolution=32, fmap_base=128, fmap_max=16, mbstd_group_size=2)
    return G, D, create_train_state(G, D, generator=torch.Generator().manual_seed(0))


def stub_loop(submit_config=None, metric_arg_list=(), device="cpu", **kwargs):
    """Stands in for the training loop under module 1's arguments: at each
    of ``STUB["evals"]`` it writes what the loop writes at a network
    snapshot, through the port's writers: the snapshot, the checkpoint
    ``step_<cur_nimg>``, and the metric's line (``MetricBase.run`` with the
    modes handed to it). Raises at the end if ``STUB["crash"]``."""
    run_dir = submit_config.run_dir
    G, D, state = _narrow_state()
    modes = iter(STUB["evals"])

    def handed_modes(metric, sampler, num_images, classifier_weights):
        return next(modes)[1], SimpleNamespace(mode="pretrained")

    with pytest.MonkeyPatch.context() as m:
        m.setattr(tmc, "fake_modes", handed_modes)
        for nimg, _ in STUB["evals"]:
            pkl = os.path.join(run_dir, f"network-snapshot-{nimg // 1000:06d}.pkl")
            misc.save_pkl(snapshot_dict(G, D, state), pkl)
            save_checkpoint(os.path.join(run_dir, "checkpoints"), state,
                            imle_state={"cursor": nimg, "staleness": 10}, step=nimg)
            for args in metric_arg_list:
                run_metric(args, network_pkl=pkl, run_dir=run_dir, device=device)
    if STUB["crash"]:
        raise RuntimeError("the stand-in loop crashed")


def _modes(count):
    """Modes of 1000 samples with exactly ``count`` distinct values."""
    return np.arange(1000) % count


def port_run(root, evals, crash=False):
    """Module 1 with the stand-in loop; returns its run dir."""
    STUB.update(evals=[(n, _modes(c)) for n, c in evals], crash=crash)
    real = run_harness.submit_run
    with pytest.MonkeyPatch.context() as m:
        m.setattr(run_harness, "submit_run",
                  lambda sc, fn, **kw: real(sc, STUB_LOOP, **kw))
        try:
            exp.main(["--result-root", str(root), "--device", "cpu", "--data-size", "2048"])
        except RuntimeError:
            assert crash
    (run_dir,) = [os.path.join(root, d) for d in os.listdir(root) if d[:5].isdigit()]
    return run_dir


WATCHDOG_CASES = {
    # the trainer crashed (an error file beside _finished.txt): from the run's
    # latest complete checkpoint; an interrupted save of a later step is skipped
    "crash": dict(evals=[(80384, 600), (100352, 700), (120320, 690)], crash=True,
                  resume=lambda run, pkl: ["--resume-checkpoint",
                                           f"{run}/checkpoints/step_00120320",
                                           "--resume-staleness", "1"]),
    # collapsed below its own peak (700 at 100 kimg, then 500): from the
    # checkpoint of its best evaluation
    "collapse": dict(evals=[(80384, 600), (100352, 700), (120320, 500)], crash=False,
                     resume=lambda run, pkl: ["--resume-checkpoint",
                                              f"{run}/checkpoints/step_00100352",
                                              "--resume-staleness", "1"]),
    # collapsed, and a weights-only fallback scores higher than any
    # checkpoint: from that snapshot with the lr rampup
    "collapse_pkl": dict(evals=[(80384, 600), (100352, 700), (120320, 500)], crash=False,
                         resume=lambda run, pkl: ["--resume-pkl", pkl, "--resume-staleness",
                                                  "1", "--resume-rampup-kimg", "40"]),
}


def _stub_exp(tmp_path, monkeypatch):
    """A stub --exp-script that logs its arguments and exits."""
    stub = tmp_path / "stub_exp.py"
    stub.write_text("import json, os, sys\n"
                    "with open(os.environ['STUB_EXP_LOG'], 'a') as f:\n"
                    "    f.write(json.dumps(sys.argv[1:]) + '\\n')\n")
    monkeypatch.setenv("STUB_EXP_LOG", str(tmp_path / "stub_exp.log"))
    return stub


@pytest.mark.parametrize("case", sorted(WATCHDOG_CASES))
def test_watchdog_relaunches_a_port_run(case, tmp_path, monkeypatch):
    """The watchdog, unchanged, supervising a port run whose trainer is gone
    relaunches the stub once with its resume arguments (a second relaunch
    passes ``--max-relaunches 1``, so it exits); module 1 parses them. The
    relaunch's output file goes to ``tmp_path`` and its sleeps are cut."""
    spec = WATCHDOG_CASES[case]
    root = tmp_path / "results"
    run = port_run(root, spec["evals"], spec["crash"])
    if case == "crash":  # an interrupted save leaves only its temporary dir
        os.makedirs(os.path.join(run, "checkpoints", "step_00140288.tmp4242"))
    pkl = str(tmp_path / "fallback" / "network-snapshot-000090.pkl")
    stub = _stub_exp(tmp_path, monkeypatch)
    launch = f"--data-dir {tmp_path}/d --data-size 2048 --result-root {root}"
    argv = ["--run-dir", run, "--pid-file", str(tmp_path / "run.pid"), "--result-root",
            str(root), "--poll-sec", "0", "--max-relaunches", "1", "--d-lrate", "0.002",
            "--exp-script", str(stub), "--repo-root", ROOT, "--launch-args", launch]
    if case == "collapse_pkl":
        argv += ["--fallback-pkl", pkl, "--fallback-pkl-count", "800"]

    watchdog = _tool("watchdog_mode_coverage")

    def tmp_open(path, *args, **kwargs):
        if isinstance(path, str) and path.startswith("/tmp/exp_relaunch_"):
            path = str(tmp_path / os.path.basename(path))
        return builtins.open(path, *args, **kwargs)

    monkeypatch.setattr(watchdog, "open", tmp_open, raising=False)
    monkeypatch.setattr(watchdog, "time", SimpleNamespace(
        time=time.time, strftime=time.strftime, sleep=lambda s: time.sleep(0.05)))
    monkeypatch.setattr(sys, "argv", ["watchdog_mode_coverage.py"] + argv)
    with pytest.raises(SystemExit) as e:
        watchdog.main()
    log = (root / "watchdog.log").read_text()
    assert e.value.code == 0, log
    assert [c for _, c, _ in watchdog.read_metrics(run)] == [c for _, c in spec["evals"]]
    (relaunched,) = [json.loads(ln) for ln in open(tmp_path / "stub_exp.log")]
    assert relaunched == launch.split() + spec["resume"](run, pkl) + [
        "--d-lrate", "0.002", "--rec-weight", "2.5"]
    assert log.count("relaunch #1") == 1 and "max relaunches (1) reached" in log
    args = exp.parse_args(relaunched)
    assert args.resume_staleness == 1
    if case == "collapse_pkl":
        assert (args.resume_pkl, args.resume_rampup_kimg) == (pkl, 40.0)
    else:
        assert os.path.isfile(os.path.join(args.resume_checkpoint, "state.pt"))


def test_mirror_restore_and_eval_artifact_on_a_port_run(tmp_path, monkeypatch):
    from inclusivegan_torch import run_metrics
    from inclusivegan_torch.metrics.metric_defaults import metric_defaults
    from inclusivegan_torch.scripts import eval_artifact
    from inclusivegan_torch.training.checkpoint import load_checkpoint
    from inclusivegan_torch.training.training_loop import load_snapshot
    from inclusivegan_torch.utils.easydict import EasyDict
    root = tmp_path / "results"
    run = port_run(root, [(2048, 37)])
    art, bak = tmp_path / "art", tmp_path / "bak"
    weights = str(art / "best_weights_fp16.pkl")
    subprocess.run([sys.executable, os.path.join(ROOT, "scripts", "mirror_best_checkpoint.py"),
                    "--once", "--result-root", str(root), "--backup-dir", str(bak),
                    "--record-file", str(art / "rec.json"), "--weights-file", weights],
                   check=True, capture_output=True, timeout=300)
    best = json.load(open(bak / "BEST.json"))
    assert (best["count"], best["kimg"], best["checkpoint"]) == (37, 2, str(bak / "step_00002048"))
    assert json.load(open(weights + ".json"))["g_loss_batched"] is True
    _, imle = load_checkpoint(best["checkpoint"], _narrow_state()[2])
    assert imle == {"cursor": 2048, "staleness": 10}
    with open(weights, "rb") as f:
        mirrored = pickle.load(f)
    assert mirrored["mirror_meta"]["src_run"] == run

    out = subprocess.run([sys.executable, os.path.join(ROOT, "scripts", "restore_best_weights.py"),
                          "--weights-file", weights, "--out-dir", str(tmp_path / "restore")],
                         check=True, capture_output=True, text=True, timeout=300).stdout
    restored = json.loads(out[:out.index("\n\nresume")])["snapshot"]
    assert misc.parse_kimg_time_from_log(str(tmp_path / "restore" / "log.txt")) == (2.0, 0.0)
    _, _, got = load_snapshot(restored, device="cpu")
    _, _, want = load_snapshot(os.path.join(run, "network-snapshot-000002.pkl"), device="cpu")
    assert set(got) == set(want)
    for net in want:
        assert set(got[net]) == set(want[net])
        for k, v in want[net].items():
            w = v.half().float() if v.is_floating_point() else v
            assert got[net][k].dtype == w.dtype and torch.equal(got[net][k], w), (net, k)

    for name in ("mode_counts_24k", "KL24k"):
        monkeypatch.setitem(metric_defaults, name,
                            EasyDict(metric_defaults[name], num_images=64))
    results = run_metrics.main(["--network", restored, "--metrics", "mode_counts_24k,KL24k",
                                "--result-dir", str(tmp_path / "eval"), "--classifier-weights",
                                MNIST_NPZ, "--data-dir", str(tmp_path), "--dataset", "none",
                                "--device", "cpu"])
    (eval_dir,) = os.listdir(tmp_path / "eval")
    monkeypatch.setattr(eval_artifact, "RECORD", str(art / "best_weights_eval.json"))
    record = eval_artifact.main(["--record-only", str(tmp_path / "eval" / eval_dir),
                                 "--weights-file", weights, "--classifier", MNIST_NPZ])
    assert record == json.load(open(art / "best_weights_eval.json"))
    assert sorted(record) == sorted([
        "artifact", "artifact_sha256", "mode_counts_24k", "KL24k", "kimg", "src_run",
        "g_loss_batched", "classifier", "eval_run_dir", "evaluated_utc", "note"])
    assert record["mode_counts_24k"] == results["mode_counts_24k"]
    assert record["KL24k"] == pytest.approx(results["mode_counts_24k_KL"], abs=5e-5)
    assert (record["kimg"], record["src_run"], record["g_loss_batched"]) == (2, run, True)
    assert record["artifact_sha256"] == hashlib.sha256(open(weights, "rb").read()).hexdigest()
    assert "inclusivegan_torch.run_metrics" in record["note"] and "TPU" not in record["note"]


def test_bench_dci_build_fits_the_power_law(capsys):
    from inclusivegan_torch.scripts import bench_dci_build
    rows, c, p = bench_dci_build.main(["--dim", "16", "--sizes", "512,1024,2048"])
    assert [n for n, _ in rows] == [512, 1024, 2048] and all(t > 0 for _, t in rows)
    assert np.isfinite(c) and np.isfinite(p) and c > 0
    out = capsys.readouterr().out.splitlines()
    assert [re.match(r"n=\s*(\d+)  build\s+[\d.]+ s  \([\d,]+ pts/s\)$", ln).group(1)
            for ln in out[:3]] == ["512", "1024", "2048"]
    assert re.match(r"fit: t = \S+ \* n\*\*-?[\d.]+$", out[4])
    assert out[5].startswith("extrapolated build at n=2,400,000: ")


# ---------------------------------------------------------------------------
# The shell scripts, with stub executables.

SHELL_SCRIPTS = ["run_celeba_quality_loop", "exp_celeba_seed_noise", "exp_dtype_pair_celeba",
           "exp_invariant_rng_price", "exp_matched_arms", "rebuild_exp_artifacts"]
# the JAX scripts' commands as the port runs them (modules 4-5)
PORT_COMMANDS = {
    "run_training.py": "-m inclusivegan_torch.run_training",
    "run_metrics.py": "-m inclusivegan_torch.run_metrics",
    "run_projector.py": "-m inclusivegan_torch.run_projector",
    "run_generator.py": "-m inclusivegan_torch.run_generator",
    "dataset_tool.py": "-m inclusivegan_torch.dataset_tool",
    "scripts/train_attr_classifier.py": "-m inclusivegan_torch.scripts.train_attr_classifier",
    "scripts/train_perceptual_vgg.py": "-m inclusivegan_torch.scripts.train_perceptual_vgg",
    "scripts/train_mnist_classifier.py": "-m inclusivegan_torch.scripts.train_mnist_classifier",
    "scripts/exp_stacked_mode_coverage.py":
        "-m inclusivegan_torch.scripts.exp_stacked_mode_coverage",
}
STUBBED = ("python3", "git", "ls", "mv", "cp", "mkdir", "grep")
STUB_SOURCE = '''#!{python}
import json, os, sys
name = os.path.basename(sys.argv[0])
with open(os.environ["STUB_LOG"], "a") as f:
    f.write(json.dumps([name, os.getcwd(), os.environ.get("JAX_PLATFORMS")] + sys.argv[1:])
            + "\\n")
if name == "python3" and sys.argv[1:2] == ["scripts/select_best_snapshot.py"]:
    print(sys.argv[2] + "/network-snapshot-000150.pkl")
if name == "ls":
    print(sys.argv[-1].replace("*", "X").replace("[0-9]", "0"))
'''


@pytest.fixture(scope="module")
def stub_tree(tmp_path_factory):
    """A tree with both scripts of each pair at their places and a bin dir
    of stubs."""
    tree = tmp_path_factory.mktemp("shell")
    for sub in ("scripts", "inclusivegan_torch/scripts", "bin"):
        os.makedirs(tree / sub)
    for name in SHELL_SCRIPTS:
        shutil.copy(os.path.join(ROOT, "scripts", f"{name}.sh"), tree / "scripts")
        shutil.copy(os.path.join(ROOT, "inclusivegan_torch", "scripts", f"{name}.sh"),
                    tree / "inclusivegan_torch" / "scripts")
    for name in STUBBED:
        path = tree / "bin" / name
        path.write_text(STUB_SOURCE.format(python=sys.executable))
        path.chmod(path.stat().st_mode | stat.S_IXUSR)
    return tree


def _drive(tree, script, log, args=()):
    env = dict(os.environ, PATH=f"{tree / 'bin'}:{os.environ['PATH']}", STUB_LOG=str(log),
               LPIPS_NPZ=str(tree / "no_such_lpips.npz"), SEED="1001")
    env.pop("JAX_PLATFORMS", None)
    proc = subprocess.run(["bash", str(tree / script), *args], env=env, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return [json.loads(ln) for ln in open(log)], proc.stdout


def _as_port(call):
    """A logged call of a JAX shell script as the port's script makes it."""
    name, cwd, _jax_platforms, *argv = call
    if name == "python3" and argv and argv[0] in PORT_COMMANDS:
        argv = PORT_COMMANDS[argv[0]].split() + argv[1:]
    return [name, cwd] + argv


@pytest.mark.parametrize("script", SHELL_SCRIPTS)
def test_shell_script_runs_the_jax_scripts_commands_through_the_port(script, stub_tree):
    """Every stage's command, in order, with identical arguments and working
    directory; ``git`` runs only as the stub; the port's ``python3`` calls
    are the port's modules or the scripts that run unchanged, never a JAX
    command or ``JAX_PLATFORMS``."""
    args = ["A", "B", "C", "D"] if script == "exp_matched_arms" else []
    want, want_out = _drive(stub_tree, f"scripts/{script}.sh",
                            stub_tree / f"{script}.jax.log", args)
    got, got_out = _drive(stub_tree, f"inclusivegan_torch/scripts/{script}.sh",
                          stub_tree / f"{script}.port.log", args)
    assert [c[:2] + c[3:] for c in got] == [_as_port(c) for c in want]
    assert len(got) >= 3 and all(c[1] == str(stub_tree) for c in got)
    for name, _cwd, jax_platforms, *argv in got:
        assert jax_platforms is None
        if name == "python3":
            assert argv[0] == "-m" and argv[1].startswith("inclusivegan_torch.") or \
                argv[0].startswith("scripts/") and argv[0] not in PORT_COMMANDS, argv
    assert re.sub(r"\d{6}", "", got_out) == re.sub(r"\d{6}", "", want_out)
