"""Data parallelism of the port (``inclusivegan_torch.parallel``) on the CPU,
in gloo process groups of two ranks.

- The train step on two ranks against the JAX package's step on a
  two-device CPU mesh, through its golden
  (``tests/torch_golden/step_dp2_golden.npz``, written by
  ``make_step_golden.py``: the narrow 16 px networks at a global minibatch
  of 4, 2 per device, with every draw re-derived per device), in the
  default config and with ``invariant_rng``: each phase's scalars and
  gradient (the first Adam moment, beta1 = 0) and after the iteration the
  second moments, pl_mean and dlatent_avg, at the tolerances of
  ``tests/test_torch_train_step.py``; both ranks bit-identical.
- The step with no group is the single-card step: equal bit for bit to the
  step in a group of one rank, and it calls no collective.
- With ``invariant_rng`` and no minibatch stddev, two ranks compute what
  one process computes on the whole batch.
- ``run_training --device cpu --num-gpus 2`` for 4 iterations at 16 px.
- ``GsSampler`` split over two ranks against one rank, and a metric
  through it.

The ranks (``torch_golden/dp_ranks.py``) import no JAX. They are spawned
once for the step, sampler and metric tests; the CLI spawns its own.
"""

import os

import jax
import numpy as np
import pytest
import torch

from inclusivegan_torch import run_training
from inclusivegan_torch.data.dataset_tool import TFRecordExporter
from inclusivegan_torch.metrics.metric_base import GsSampler, run_metric
from inclusivegan_torch.snapshot import snapshot_dict
from inclusivegan_torch.training import train_step as tstep
from inclusivegan_torch.training.train_state import create_train_state
from inclusivegan_torch.utils import misc
from inclusivegan_tpu.models.lpips import init_pixel_fallback_params
from torch_golden import dp_ranks
from torch_golden.narrow_nets import ZDIM, narrow_nets, to_port

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_golden",
                      "step_dp2_golden.npz")
CONFIGS = {"dp2": {}, "dp2_invariant": dict(invariant_rng=True)}
CFG = dict(gamma=100.0, mirror_augment=True)
HPARAMS = (0.002, 0.002, 0.99, 2.5)  # G and D learning rates, Gs beta, rec weight
PHASES = dp_ranks.PHASES


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread here, and so for the ranks the CLI spawns: under
    the suite's parallel workers, more threads contend for the cores (the
    CLI's two ranks at 4 threads each took 221 s there instead of 13)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _close(port, ref, err_msg=""):
    """Within 2e-3 relative + 1e-5 absolute of the largest entry, as in
    tests/test_torch_train_step.py."""
    ref = np.asarray(ref)
    scale = max(float(np.abs(ref).max()), 1e-12)
    np.testing.assert_allclose(port, ref, rtol=2e-3, atol=1e-5 + 2e-3 * scale,
                               err_msg=err_msg)


def _nets(**kw):
    G, D, gp, dp, gc, dc = narrow_nets(**kw)
    TG, TD = to_port(gc, gp, dc, dp)
    TGs, _ = to_port(gc, gp, dc, dp)
    return TG, TD, TGs


def _snapshot(root):
    TG, TD, TGs = _nets()
    pkl = str(root / "net.pkl")
    misc.save_pkl(snapshot_dict(TG, TD, create_train_state(TG, TD, TGs)), pkl)
    return pkl


# a metric whose feature is each fake's mean pixel, 40 fakes in chunks of 8
METRIC = dict(name="mean_pixel", func_name="torch_golden.dp_ranks.mean_pixel_metric",
              num_images=40, minibatch_per_gpu=8)
LATENTS = np.random.RandomState(1).randn(10, ZDIM).astype(np.float32)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """On two ranks, in one spawn: each golden configuration's iteration,
    rank 0's bits of the step with no group and in a group of one, and
    invariant_rng without the minibatch stddev on the ranks and in one
    process; then the sampler on 10 latents at minibatch 4, and the metric
    above into ``two/``. Returns (root, snapshot, results by rank)."""
    root = tmp_path_factory.mktemp("ranks")
    pkl = _snapshot(root)
    (root / "two").mkdir()
    lp = jax.tree_util.tree_map(np.asarray, init_pixel_fallback_params())
    return root, pkl, dp_ranks.run_ranks(2, "several", [
        ("golden_rank", (_nets(), lp, GOLDEN, CONFIGS, CFG, HPARAMS,
                         _nets(mbstd_group_size=1))),
        ("sampler_rank", (pkl, LATENTS, 4)),
        ("metric_rank", (METRIC, pkl, str(root / "two")))])


@pytest.fixture(scope="module")
def golden_ranks(ranks):
    """Each rank's golden_rank results."""
    return [r[0] for r in ranks[2]]


@pytest.mark.parametrize("phase", range(4), ids=[p for p, _ in PHASES])
@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_two_ranks_match_the_jax_two_device_step(golden_ranks, config, phase):
    """Each phase's scalars (averaged over the ranks), gradient (averaged
    before Adam) and Adam count against the JAX two-device step's."""
    golden = np.load(GOLDEN)
    name, _opt = PHASES[phase]
    after = golden_ranks[0][0][config][0][phase]
    pre = f"{config}/scalar/{name}/"
    want = {k[len(pre):]: float(golden[k]) for k in golden.files if k.startswith(pre)}
    assert set(after["scalars"]) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(after["scalars"][k], v, rtol=1e-4, atol=1e-5, err_msg=k)
    pre = f"{config}/m/{name}/"
    jm = {k[len(pre):]: golden[k] for k in golden.files if k.startswith(pre)}
    assert set(after["m"]) == set(jm)
    for k, v in after["m"].items():
        _close(v, jm[k], f"{config} {name} gradient of {k}")
    assert after["count"] == int(golden[f"{config}/count/{name}"])


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_two_ranks_state_matches_jax(golden_ranks, config):
    """v, pl_mean (averaged over the ranks) and dlatent_avg (the averaged
    batch averages folded in) after the iteration."""
    golden = np.load(GOLDEN)
    state = golden_ranks[0][0][config][1]
    for opt in ("g_opt", "d_opt"):
        pre = f"{config}/v/{opt}/"
        names = [k[len(pre):] for k in golden.files if k.startswith(pre)]
        assert names
        for k in names:
            _close(state[f"{opt}.v.{k}"], golden[pre + k], f"{config} {opt}.v of {k}")
    np.testing.assert_allclose(state["pl_mean"], golden[f"{config}/pl_mean"],
                               rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(state["G.dlatent_avg"], golden[f"{config}/dlatent_avg"],
                               rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_both_ranks_end_bit_identical(golden_ranks, config):
    """Parameters, Adam moments and counts, pl_mean and the Gs of both
    ranks, and every phase's scalars, equal bit for bit."""
    (after0, state0), (after1, state1) = (r[0][config] for r in golden_ranks)
    assert state0.keys() == state1.keys()
    for k in state0:
        np.testing.assert_array_equal(state0[k], state1[k], err_msg=k)
    assert [a["scalars"] for a in after0] == [a["scalars"] for a in after1]


def test_no_group_step_is_the_single_card_step(golden_ranks, monkeypatch):
    """With no group the step is the single-card one: bit for bit the step
    in a group of one rank, whose means are exact; and it reaches no
    collective."""
    none, solo = golden_ranks[0][1]
    assert none.keys() == solo.keys()
    for k in none:
        np.testing.assert_array_equal(none[k], solo[k], err_msg=k)

    def no_collective(*args, **kwargs):
        raise AssertionError("a collective without a group")

    monkeypatch.setattr(tstep, "all_reduce_mean_", no_collective)
    monkeypatch.setattr(tstep, "all_reduce_mean", no_collective)
    golden = np.load(GOLDEN)
    batch = {k[len("batch/"):]: golden[k][:len(golden[k]) // 2]
             for k in golden.files if k.startswith("batch/")}
    for name, fields in CONFIGS.items():
        pre = f"{name}/draws0/"
        draws = tstep.unflatten_draws(
            {k[len(pre):]: golden[k] for k in golden.files if k.startswith(pre)})
        lp = jax.tree_util.tree_map(np.asarray, init_pixel_fallback_params())
        after, _ = dp_ranks._iteration(_nets(), lp, batch, draws,
                                       tstep.TrainConfig(**CFG, **fields), None, *HPARAMS)
        assert len(after) == 4


@pytest.mark.parametrize("phase", range(4), ids=[p for p, _ in PHASES])
def test_two_ranks_equal_one_process_under_invariant_rng(golden_ranks, phase):
    """With invariant_rng and no minibatch stddev, 2 ranks of 2 compute
    what one process computes on the 4 examples: scalars within 1e-5
    relative + 1e-6, half the ranks' summed gradient within 1e-5 relative
    L2 of each parameter's (float32 sums in another order), the path-length
    penalty centred on all ranks' examples."""
    (mine, _), (whole, _) = golden_ranks[0][2]
    got, want = mine[phase], whole[phase]
    assert set(got["scalars"]) == set(want["scalars"])
    for k, v in want["scalars"].items():
        np.testing.assert_allclose(got["scalars"][k], v, rtol=1e-5, atol=1e-6, err_msg=k)
    for k, v in want["m"].items():
        err = np.linalg.norm(got["m"][k] / 2 - v) / max(np.linalg.norm(v), 1e-30)
        assert err <= 1e-5, (PHASES[phase][0], k, err)


def _write_set(root, name, num, res=16):
    r = np.random.RandomState(0)
    with TFRecordExporter(os.path.join(root, name), num, print_progress=False) as tfr:
        for _ in range(num):
            tfr.add_image(r.randint(0, 256, (3, res, res)).astype(np.uint8))


def test_run_training_on_two_cpu_ranks(tmp_path):
    """``run_training --device cpu --num-gpus 2 --metrics none``: 4
    iterations of config-e at 16 px on two gloo ranks, one image each (a
    full-width iteration takes seconds on the CPU), in one run dir
    named ``-2dev`` that rank 0 alone writes; both ranks end with the same
    G, D, Gs and Adam moments."""
    _write_set(str(tmp_path / "data"), "toy", 16)
    results = tmp_path / "results"
    run_training.main([
        "--data-dir", str(tmp_path / "data"), "--dataset", "toy", "--device", "cpu",
        "--num-gpus", "2", "--metrics", "none", "--result-dir", str(results),
        "--minibatch-gpu", "1", "--data-size", "16", "--num-samples-factor", "1",
        "--candidate-batch-size", "16", "--smoke-test-max-iters", "4"])
    (run_dir,) = [results / d for d in os.listdir(results)]
    assert "-2dev-" in run_dir.name
    files = sorted(os.listdir(run_dir))
    assert files == sorted(["_finished.txt", "arb-reals.png", "log.txt", "network-final.pkl",
                            "run.txt", "stats.jsonl", "submit_config.pkl",
                            "submit_config.txt"] + [f for f in files
                                                    if f.startswith("events.")]), files
    log = (run_dir / "log.txt").read_text()
    assert "on localhost, 2 ranks" in log and "devices: 2" in log
    assert "replicas: 2 ranks, G, D, Gs and Adam moments identical" in log
    assert log.count("Training for") == 1  # rank 1 printed nothing here


def test_run_metric_on_two_ranks_equals_one(ranks, tmp_path):
    """A metric through ``metric_base.run_metric`` on two ranks (each
    fake's mean pixel, 40 fakes in chunks of 8): rank 0 gathers the fakes,
    computes the value one rank computes and alone writes its line; rank 1
    serves the sampler and returns nothing."""
    root, pkl, results = ranks
    one = run_metric(METRIC, network_pkl=pkl, run_dir=str(tmp_path), device="cpu",
                     mirror_augment=False)
    two, served = (r[2] for r in results)
    assert served == {} and 0 < one["mean_pixel"] < 255 and two == one
    assert os.listdir(root / "two") == ["metric-mean_pixel.txt"]
    (line,) = (root / "two" / "metric-mean_pixel.txt").read_text().splitlines()
    assert f"mean_pixel {one['mean_pixel']:-10.4f}" in line


def test_sampler_on_two_ranks_equals_one_rank(ranks):
    """The Gs images of 10 latents at minibatch 4 (the last batch padded),
    split over two ranks, equal one rank's: each rank draws the whole
    minibatch's noise and keeps its slice."""
    _root, pkl, results = ranks
    one = GsSampler(pkl, minibatch_size=4, device="cpu").run(LATENTS)
    two, none = (r[1] for r in results)
    assert none is None and one.shape == (10, 3, 16, 16) and one.dtype == np.uint8
    np.testing.assert_array_equal(two, one)
