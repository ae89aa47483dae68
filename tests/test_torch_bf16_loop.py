"""The bfloat16 loop of the port against the JAX loop's control flow and
dtypes, on the CPU (moved out of test_torch_bf16.py, whose helpers and
narrow networks it uses, so that ``--dist loadfile`` runs it on a worker of
its own)."""

import numpy as np

from test_torch_bf16 import BF16_NETS, _run_loop
from test_torch_training_loop import toy_dataset  # noqa: F401


def test_loop_control_flow_and_dtypes_match_the_jax_loop_at_bf16(toy_dataset, tmp_path,  # noqa: F811
                                                                  monkeypatch):
    """dtype bfloat16 and lpips_norm "trunk" from a fresh init: both loops
    make the same steps with the same hyperparameters and real batches, give
    the train step the same compute dtypes, draw bf16 images from the state,
    write files of the same names and store "bfloat16" in the snapshot."""
    kw = dict(BF16_NETS, lpips_norm="trunk", prefetch_depth=0, init_staleness=1,
              total_kimg=0.064, seed=5,
              sched_args=dict(minibatch_size_base=8, minibatch_gpu_base=8,
                              tick_kimg_base=0.032))
    out = {}
    for package in ("jax", "port"):
        with monkeypatch.context() as m:
            out[package] = _run_loop(package, toy_dataset, str(tmp_path / package), m, **kw)
    (jrec, jfiles, jconf), (rec, files, conf) = out["jax"], out["port"]
    assert len(rec.steps) == len(jrec.steps) > 0
    for s, j in zip(rec.steps, jrec.steps):
        assert s["hp"] == j["hp"]
        for k in s["batch"]:
            np.testing.assert_array_equal(s["batch"][k], j["batch"][k])
    assert rec.dtypes == jrec.dtypes == dict(
        mapping="bfloat16", synthesis="bfloat16", D="bfloat16", lpips="bfloat16",
        lpips_norm="trunk", images="bfloat16")
    assert files == jfiles
    assert conf == jconf == ("bfloat16", "bfloat16")
