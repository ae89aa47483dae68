"""The port's training loop running its metrics at each network snapshot,
on the CPU (moved out of test_torch_metrics.py so that ``--dist loadfile``
runs it on a worker of its own)."""

import os

from inclusivegan_torch.metrics.metric_defaults import metric_defaults
from inclusivegan_torch.utils.run_harness import SubmitConfig
from test_torch_training_loop import LOOP, _args, one_torch_thread, toy_dataset  # noqa: F401


def test_loop_runs_metrics_at_each_network_snapshot(toy_dataset, tmp_path):  # noqa: F811
    """The loop runs every metric on each network snapshot it writes; one
    that fails is printed and training goes on."""
    from inclusivegan_torch.utils.run_harness import submit_run
    broken = dict(name="broken", func_name="inclusivegan_torch.metrics.metric_base."
                                           "MetricBase")
    root = str(tmp_path / "results")
    state = submit_run(SubmitConfig(run_dir_root=root, run_desc="metrics"), LOOP,
                       **_args(toy_dataset, metric_arg_list=[metric_defaults["dummy"],
                                                             broken],
                               total_kimg=0.032, network_snapshot_ticks=1,
                               image_snapshot_ticks=100, prefetch_depth=0,
                               save_full_checkpoints=False, seed=3, device="cpu",
                               sched_args=dict(minibatch_size_base=8,
                                               minibatch_gpu_base=8,
                                               tick_kimg_base=0.016)))
    run_dir = os.path.join(root, "00000-metrics")
    # two ticks, two network snapshots; at this scale both are named for 0 kimg
    lines = open(os.path.join(run_dir, "metric-dummy.txt")).read().splitlines()
    assert len(lines) == 2 and int(state.step) == 4
    assert all(line.startswith("network-snapshot-000000 ") for line in lines)
    assert open(os.path.join(run_dir, "log.txt")).read().count("metric broken failed") == 2
