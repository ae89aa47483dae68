"""The port's counterparts of the repository's ``scripts/``, each run as
``python -m inclusivegan_torch.scripts.<name>`` with the flags and defaults
of ``python scripts/<name>.py``.

The scripts that make a run's inputs:

- ``train_mnist_classifier``: the stacked-MNIST mode classifier
  (``mode_counts``, ``KL``) from MNIST idx files;
- ``train_attr_classifier``: the CelebA 40-attribute classifier (``ls``,
  the minority filter) from a TFRecord set with 40 labels;
- ``train_perceptual_vgg``: the domain perceptual VGG16 and its LPIPS
  calibration, the npz of ``--lpips-weights``;
- ``convert_reference_pkl``: a ``dump_reference_vars.py`` npz to a
  ``network_snapshot.v1`` pickle.

The experiment scripts:

- ``exp_stacked_mode_coverage``: the stacked-MNIST mode-coverage run, which
  ``scripts/watchdog_mode_coverage.py`` relaunches (``--exp-script
  inclusivegan_torch/scripts/exp_stacked_mode_coverage.py``);
- ``eval_artifact``: ``mode_counts_24k`` and ``KL24k`` of the fp16
  best-weights mirror, restored by ``scripts/restore_best_weights.py``;
- ``bench_dci_build``: the host DCI index's build time against the pool
  size, and its power-law fit;
- ``multihost_worker``: one process of a two-process training step over
  ``torch.distributed``;
- the shell scripts ``run_celeba_quality_loop.sh``, ``exp_*.sh`` and
  ``rebuild_exp_artifacts.sh``: the stages of ``scripts/<name>.sh``, each as
  its port command.

The host tools ``scripts/mirror_best_checkpoint.py``,
``restore_best_weights.py``, ``watchdog_mode_coverage.py``,
``select_best_snapshot.py``, ``record_quality_digest.py`` and
``mirror_snapshot.py`` import no JAX and run unchanged on the port's run
dirs. The scripts write the files the JAX package's scripts write, which
both packages read. They run on ``cuda`` unless ``--device cpu`` is passed,
with TF32 off, as ``run_training`` trains.
"""
