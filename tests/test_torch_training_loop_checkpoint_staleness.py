"""The port's training loop against the JAX loop's control flow, case
"resume_checkpoint_staleness" (--resume-checkpoint from each package's own
checkpoint with resume_staleness=1: the rebuild points): see
``check_control_flow`` and ``PARITY`` in test_torch_training_loop.py. Each
case runs both loops on the CPU, so each has a file of its own, which
``--dist loadfile`` gives to its own worker."""

import pytest

from test_torch_training_loop import check_control_flow, one_torch_thread, toy_dataset  # noqa: F401


@pytest.mark.parametrize("case", ["resume_checkpoint_staleness"])
def test_control_flow_matches_the_jax_loop(toy_dataset, tmp_path, monkeypatch, case):  # noqa: F811
    check_control_flow(toy_dataset, tmp_path, monkeypatch, case)
