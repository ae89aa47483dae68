"""The port's training loop on the CPU at 16 px with narrow networks,
mirroring tests/test_end_to_end.py: the run-dir artifacts (the PNG grids
decoded by PIL at the grid's shape), the step count, resume from a snapshot
(kimg and time read from its log.txt) and from a full-state checkpoint
(Adam count, step and the IMLE counters).

Both loops take the whole minibatch on one device (``minibatch_gpu_base``
equal to ``minibatch_size_base``): the JAX fixture's ``MB // 8`` per device
would need gradient accumulation, which is not ported yet.

The control-flow parity test replaces ``make_train_step`` in both loops by a
recorder (monkeypatched; the JAX package is not edited) and runs both on the
same data, seed and arguments: they must make the same sequence of
(cur_nimg, G_lrate, D_lrate, gs_beta, do_g_reg, do_d_reg, rec_weight) and
real minibatches (bit for bit), rebuild the IMLE pool at the same points,
tick at the same cur_nimg and write files of the same names."""

import json
import math
import os
import re
import shutil
import time

import numpy as np
import PIL.Image
import pytest
import torch

from inclusivegan_torch.metrics.metric_defaults import metric_defaults
from inclusivegan_torch.utils import misc
from inclusivegan_torch.utils.misc import create_image_grid, save_image_grid, write_png
from inclusivegan_torch.utils.run_harness import SubmitConfig, submit_run
from inclusivegan_tpu.data.dataset_tool import TFRecordExporter

RES = 16
DATA_SIZE = 64
MB = 8
NETS = dict(G_args=dict(fmap_base=256, fmap_max=32, latent_size=32, dlatent_size=32,
                        mapping_layers=2, mapping_fmaps=32),
            D_args=dict(fmap_base=256, fmap_max=32, mbstd_group_size=2))
LOOP = "inclusivegan_torch.training.training_loop.training_loop"


@pytest.fixture(scope="module")
def toy_dataset(tmp_path_factory):
    """The JAX package's exporter, as in tests/test_end_to_end.py."""
    d = str(tmp_path_factory.mktemp("data") / "toy")
    r = np.random.RandomState(0)
    images = r.randint(0, 256, (DATA_SIZE, 3, RES, RES)).astype(np.uint8)
    labels = np.zeros((DATA_SIZE, 4), np.float32)
    labels[np.arange(DATA_SIZE), r.randint(4, size=DATA_SIZE)] = 1.0
    with TFRecordExporter(d, DATA_SIZE, print_progress=False) as tfr:
        for img in images:
            tfr.add_image(img)
        tfr.add_labels(labels)
    return d


def _args(toy_dataset, **kw):
    args = dict(
        **NETS,
        G_loss_args=dict(NN_rec_lpips_weight=2.5), D_loss_args=dict(gamma=10.0),
        dataset_args=dict(tfrecord_dir=os.path.basename(toy_dataset),
                          max_label_size="full"),
        sched_args=dict(minibatch_size_base=MB, minibatch_gpu_base=MB,
                        tick_kimg_base=0.001),
        data_dir=os.path.dirname(toy_dataset), total_kimg=1, data_size=DATA_SIZE,
        num_epochs=1, num_samples_factor=2, init_staleness=10, candidate_batch_size=32,
        knn_perturb_factor=0.05, init_proj_dim=16, metric_arg_list=[],
        minibatch_repeats=2, num_devices=1)
    args.update(kw)
    return args


@pytest.fixture(scope="module")
def trained_run(toy_dataset, tmp_path_factory):
    root = str(tmp_path_factory.mktemp("results"))
    state = submit_run(SubmitConfig(run_dir_root=root, run_desc="smoke"), LOOP,
                       **_args(toy_dataset, smoke_test_max_iters=3, seed=5, device="cpu"))
    return os.path.join(root, "00000-smoke"), state


def _png(path):
    return np.asarray(PIL.Image.open(path))


def _stat_steps(run_dir):
    """cur_nimg of each flush of stats.jsonl: the ticks, then the end."""
    with open(os.path.join(run_dir, "stats.jsonl")) as f:
        return [json.loads(line)["_step"] for line in f]


def test_run_dir_artifacts(trained_run):
    run_dir, _ = trained_run
    names = set(os.listdir(run_dir))
    for expected in ["log.txt", "run.txt", "submit_config.pkl", "submit_config.txt",
                     "arb-reals.png", "_finished.txt", "network-final.pkl", "stats.jsonl",
                     "arb-fakes-000000.png", "rec-reals.png", "rec-fakes-000000.png",
                     "network-snapshot-000000.pkl", "checkpoints"]:
        assert expected in names, (expected, names)
    assert any(n.startswith("events.out.tfevents.") for n in names)
    # 1080p at 16 px: a grid of 32 x 32 images; the rec grids hold one
    # iteration's 2 x 8 rec reals, 4 x 4
    assert _png(os.path.join(run_dir, "arb-fakes-000000.png")).shape == (512, 512, 3)
    assert _png(os.path.join(run_dir, "rec-reals.png")).shape == (64, 64, 3)
    assert _png(os.path.join(run_dir, "rec-fakes-000000.png")).shape == (64, 64, 3)
    log = open(os.path.join(run_dir, "log.txt")).read()
    assert "tick 0" in log and "Constructing networks" in log
    assert "Timing/dci_rebuild_sec" in open(os.path.join(run_dir, "stats.jsonl")).read()


def test_reals_grid_is_the_datasets_stream(trained_run, toy_dataset):
    """arb-reals.png: the first 32 x 32 images of the fixed-order stream
    (the 64 images, wrapping), exactly."""
    from inclusivegan_torch.data.dataset import TFRecordDataset
    run_dir, _ = trained_run
    images = TFRecordDataset(toy_dataset).get_all_images()
    want = create_image_grid(images[np.arange(32 * 32) % DATA_SIZE], (32, 32))
    np.testing.assert_array_equal(_png(os.path.join(run_dir, "arb-reals.png")),
                                  want.transpose(1, 2, 0))


def test_training_made_progress(trained_run):
    _, state = trained_run
    assert int(state.step) == 3
    assert float(state.G.dlatent_avg.abs().max()) > 0
    assert int(state.g_opt.count) == 3 + 1  # G main thrice, path-length reg once


def test_snapshot_reads_back_in_the_jax_package(trained_run):
    import jax
    import jax.numpy as jnp
    from inclusivegan_tpu.training.training_loop import load_snapshot
    run_dir, state = trained_run
    G, D, params = load_snapshot(os.path.join(run_dir, "network-final.pkl"))
    z = np.random.RandomState(0).randn(4, 32).astype(np.float32)
    img = G.apply(params["gs_params"], jnp.asarray(z), jnp.zeros((4, G.mapping.label_size)),
                  rng=jax.random.key(0), truncation_psi=0.7)
    assert img.shape == (4, 3, RES, RES) and np.isfinite(np.asarray(img)).all()
    np.testing.assert_array_equal(
        np.asarray(params["d_params"]["4x4"]["Dense0"]["weight"]),
        state.D.get_submodule("4x4").Dense0.weight.detach().numpy())


def test_resume_from_snapshot_reads_kimg_and_time_from_the_log(trained_run, toy_dataset,
                                                               tmp_path):
    """--resume-pkl: the (G, D, Gs) snapshot, with kimg and the elapsed time
    taken from the last tick line of the log.txt beside it."""
    run_dir, _ = trained_run
    prev = tmp_path / "prev"
    prev.mkdir()
    pkl = str(prev / "network-snapshot-000001.pkl")
    shutil.copy(os.path.join(run_dir, "network-final.pkl"), pkl)
    (prev / "log.txt").write_text(
        "tick 3     kimg 1.5      lod 0.00 minibatch 8    time 1m 05s      "
        "sec/tick 1.0     sec/kimg 2.00\n")
    from inclusivegan_torch.training.training_loop import load_snapshot
    _, _, snap = load_snapshot(pkl, device="cpu")
    snap_w = snap["g_params"]["synthesis.4x4.Conv.weight"].numpy()

    root = str(tmp_path / "results")
    t0 = time.time()
    state = submit_run(SubmitConfig(run_dir_root=root, run_desc="resume"), LOOP,
                       **_args(toy_dataset, total_kimg=2, smoke_test_max_iters=3, seed=99,
                               resume_pkl=pkl, save_full_checkpoints=False, device="cpu"))
    wall = time.time() - t0
    new_run = os.path.join(root, "00000-resume")
    log = open(os.path.join(new_run, "log.txt")).read()
    assert "Loading networks from" in log
    tick = [ln for ln in log.splitlines() if ln.startswith("tick ")][0]
    assert "kimg 1.5" in tick, tick  # 1500 + 16 images
    # the time column goes on from the earlier run's 65 s: at least that, at
    # most that plus this run's own seconds (the column rounds to a second)
    seconds = misc._time_to_seconds(re.search(r" time (.+?)\s+sec/tick", tick).group(1))
    assert 65 <= seconds <= 65 + math.ceil(wall), (tick, wall)
    assert _stat_steps(new_run) == [1500 + 2 * MB, 1500 + 3 * MB]
    w = state.G.get_submodule("synthesis.4x4.Conv").weight.detach().numpy()
    assert 0.0 < float(np.abs(w - snap_w).max()) < 0.2
    assert int(state.step) == 3


def test_resume_from_checkpoint(trained_run, toy_dataset, tmp_path, monkeypatch):
    """--resume-checkpoint with the run dir: Adam's count and the step go on
    from the checkpoint, and the IMLE cursor and staleness are the
    checkpoint's (the resumed run asks for another init_staleness)."""
    from inclusivegan_torch.training import training_loop as tloop
    from inclusivegan_torch.training.checkpoint import STATE_FILE, latest_checkpoint
    run_dir, _ = trained_run
    ck = latest_checkpoint(os.path.join(run_dir, "checkpoints"))
    saved = torch.load(os.path.join(ck, STATE_FILE), weights_only=True)
    assert int(saved["state"]["g_opt"]["count"]) > 0

    made = []

    class Recording(tloop.IMLEOrchestrator):
        def __init__(self, **kw):
            super().__init__(**kw)
            made.append(self)

    monkeypatch.setattr(tloop, "IMLEOrchestrator", Recording)
    root = str(tmp_path / "results")
    state = submit_run(SubmitConfig(run_dir_root=root, run_desc="ckptresume"), LOOP,
                       **_args(toy_dataset, smoke_test_max_iters=1, seed=123,
                               init_staleness=3, prefetch_depth=0,
                               resume_checkpoint=run_dir, save_full_checkpoints=False,
                               device="cpu"))
    log = open(os.path.join(root, "00000-ckptresume", "log.txt")).read()
    assert "Restoring full training state" in log
    # the resumed iteration runs G main and the path-length reg: both count
    assert int(state.g_opt.count) == int(saved["state"]["g_opt"]["count"]) + 2
    assert int(state.step) == int(saved["state"]["step"]) + 1
    (imle,) = made
    assert imle.staleness == saved["imle"]["staleness"] == 10
    assert imle.cursor == saved["imle"]["cursor"] + 2 * MB  # one rec batch since


def test_default_device_needs_cuda(toy_dataset, monkeypatch, tmp_path):
    from inclusivegan_torch.training.training_loop import training_loop
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        training_loop(**_args(toy_dataset))


@pytest.mark.parametrize("metric_args", [
    [metric_defaults["fid30k"], dict(metric_defaults["ppl_wend"], space="x")],
    [dict(metric_defaults["ppl_zfull"], sampling="middle")],
    [metric_defaults["pr50k3"], dict(metric_defaults["ls"], attrib_indices=40)]])
def test_bad_metric_arguments_raise_before_the_networks(toy_dataset, metric_args, tmp_path):
    """Every metric is built before anything loads: a bad argument raises
    first, before the dataset is opened."""
    from inclusivegan_torch.training.training_loop import training_loop
    with pytest.raises((AssertionError, TypeError)):
        training_loop(**_args(toy_dataset, device="cpu", metric_arg_list=metric_args,
                              data_dir=str(tmp_path / "no-data")))


@pytest.mark.parametrize("kw,match", [
    (dict(invariant_rng=True), "queue 1 item 4"),
    (dict(sched_args=dict(minibatch_size_base=MB, minibatch_gpu_base=MB // 2)),
     "queue 1 item 4"),
    (dict(knn_backend="dci"), "queue 1 item 5"),
    (dict(knn_backend="auto", init_proj_dim=None, num_samples_factor=30000),
     "queue 1 item 5"),
    (dict(num_devices=2), "queue 1 item 6"),
])
def test_unported_knobs_raise_before_the_networks(toy_dataset, kw, match):
    from inclusivegan_torch.training.training_loop import training_loop
    with pytest.raises(NotImplementedError, match=match):
        training_loop(**_args(toy_dataset, device="cpu", **kw))


def test_png_writer_decodes_with_pil(tmp_path):
    rnd = np.random.RandomState(0)
    for shape in ((5, 7, 3), (4, 9), (6, 3, 1)):
        img = rnd.randint(0, 256, shape).astype(np.uint8)
        write_png(str(tmp_path / "x.png"), img)
        got = _png(tmp_path / "x.png")
        np.testing.assert_array_equal(got, img.reshape(got.shape))
    x = rnd.uniform(-1, 1, (6, 3, 4, 5)).astype(np.float32)
    save_image_grid(x, str(tmp_path / "g.png"), drange=(-1, 1), grid_size=(3, 2))
    from inclusivegan_tpu.utils import misc as jmisc
    want = jmisc.convert_to_uint8_pil(jmisc.create_image_grid(x, (3, 2)), (-1, 1))
    np.testing.assert_array_equal(_png(tmp_path / "g.png"), want)
    with pytest.raises(ValueError):
        write_png(str(tmp_path / "bad.png"), np.zeros((2, 2, 2), np.uint8))


# ---------------------------------------------------------------------------
# Control flow against the JAX loop.

class _Recorder:
    """Stands in for make_train_step: records each step's arguments and
    batch, returns the state unchanged and no scalars."""

    def __init__(self):
        self.steps = []

    def make(self, *args, **kwargs):
        def train_step(state, batch, _key, g_lrate, d_lrate, gs_beta, *, do_g_reg,
                       do_d_reg, rec_weight=None):
            self.steps.append(dict(
                hp=(float(np.float32(g_lrate)), float(np.float32(d_lrate)),
                    float(np.float32(gs_beta)), bool(do_g_reg), bool(do_d_reg),
                    None if rec_weight is None else float(np.float32(rec_weight))),
                batch={k: np.asarray(batch[k]).copy()
                       for k in ("reals", "reals_rec_1", "reals_rec_2")}))
            return state, {}
        return train_step


def _run_recorded(package, toy_dataset, root, monkeypatch, **kw):
    if package == "jax":
        from inclusivegan_tpu.training import imle
        from inclusivegan_tpu.training import training_loop as loop
        from inclusivegan_tpu.utils import run_harness
        name = "inclusivegan_tpu.training.training_loop.training_loop"
    else:
        from inclusivegan_torch.training import imle
        from inclusivegan_torch.training import training_loop as loop
        from inclusivegan_torch.utils import run_harness
        name, kw = LOOP, dict(kw, device="cpu")
    rec = _Recorder()
    rebuilds = []
    rebuild = imle.IMLEOrchestrator.rebuild

    def recording_rebuild(self, *a, **k):
        rebuilds.append(len(rec.steps))
        return rebuild(self, *a, **k)

    monkeypatch.setattr(loop, "make_train_step", rec.make)
    monkeypatch.setattr(imle.IMLEOrchestrator, "rebuild", recording_rebuild)
    run_harness.submit_run(run_harness.SubmitConfig(run_dir_root=root, run_desc="parity"),
                           name, **_args(toy_dataset, **kw))
    run_dir = os.path.join(root, "00000-parity")
    ticks = _stat_steps(run_dir)
    files = sorted("events.out.tfevents" if n.startswith("events.out.tfevents.") else n
                   for n in os.listdir(run_dir))
    ckpts = sorted(os.listdir(os.path.join(run_dir, "checkpoints"))) \
        if os.path.isdir(os.path.join(run_dir, "checkpoints")) else []
    return rec.steps, rebuilds, ticks, files, ckpts


PARITY = {
    # inline assembly, the IMLE pool rebuilt at 0, 64 and 128 images
    # (staleness 1, then doubled to 2), learning-rate and rec-weight ramps, both lazy
    # regularizers' cadences, snapshots every 2 and 3 ticks
    "inline_two_rebuilds": dict(
        prefetch_depth=0, init_staleness=1, total_kimg=0.144,
        sched_args=dict(minibatch_size_base=MB, minibatch_gpu_base=MB,
                        tick_kimg_base=0.032, lrate_rampup_kimg=0.1),
        rec_weight_final=5.0, rec_weight_ramp_start_kimg=0.02,
        rec_weight_ramp_end_kimg=0.1, image_snapshot_ticks=2, network_snapshot_ticks=3),
    # the prefetcher on, one rebuild (a rebuild drops the batches the
    # worker assembled ahead, which makes the later stream depend on timing)
    "prefetched": dict(prefetch_depth=2, init_staleness=100, total_kimg=0.064,
                       G_smoothing_kimg=0.5,
                       sched_args=dict(minibatch_size_base=MB, minibatch_gpu_base=MB,
                                       tick_kimg_base=0.016)),
}


@pytest.mark.parametrize("case", sorted(PARITY))
def test_control_flow_matches_the_jax_loop(toy_dataset, tmp_path, monkeypatch, case):
    kw = dict(PARITY[case], seed=5)
    out = {}
    for package in ("jax", "port"):
        with monkeypatch.context() as m:
            out[package] = _run_recorded(package, toy_dataset, str(tmp_path / package), m,
                                         **kw)
    (jsteps, jrebuilds, jticks, jfiles, jckpts) = out["jax"]
    (steps, rebuilds, ticks, files, ckpts) = out["port"]
    assert len(steps) == len(jsteps) > 0
    nimg = 0
    for i, (s, j) in enumerate(zip(steps, jsteps)):
        assert s["hp"] == j["hp"], (i, nimg, s["hp"], j["hp"])
        for k in s["batch"]:
            np.testing.assert_array_equal(s["batch"][k], j["batch"][k], err_msg=f"{i} {k}")
        nimg += s["batch"]["reals"].shape[0] // 2
    assert rebuilds == jrebuilds
    assert ticks == jticks
    assert files == jfiles
    assert ckpts == jckpts
    if case == "inline_two_rebuilds":
        assert rebuilds == [0, 8, 16] and len(steps) == 18
        assert len({s["hp"][0] for s in steps}) > 5  # the learning-rate ramp
        assert len({s["hp"][5] for s in steps}) > 5  # the rec-weight ramp
        assert [s["hp"][3] for s in steps[:5]] == [True, False, False, False, True]
        assert [i for i, s in enumerate(steps) if s["hp"][4]] == [0, 16]
