"""inclusivegan_torch: the PyTorch/CUDA port of inclusivegan_tpu for NVIDIA
H100 cards (sm_90a).

Serving: ``run_generator.generate_images`` loads a ``network_snapshot.v1``
pickle (``snapshot.load_snapshot``) and runs the Gs (mapping, truncation,
synthesis). Training: ``run_training`` (the CLI) submits
``training.training_loop.training_loop``, which trains from scratch or from
a snapshot or checkpoint on TFRecord data, with ``training.imle`` and
``training.train_step.make_train_step`` (G main, path-length reg, D main
with the Gs EMA, R1) at its core. Evaluation: ``run_metrics`` runs every
metric of ``metrics.metric_defaults``, ``run_projector`` the IvOM
projection (``projector.Projector``). ``--num-gpus N`` trains and
evaluates data-parallel, one process per card (``parallel``). All run
through two
hand-written CUDA kernels, bias+lrelu and upfirdn2d (``ops/csrc``), with
their backward passes. Entry points run on ``cuda`` unless
the caller passes ``device="cpu"``; on CPU tensors every op takes its plain
PyTorch version. Importing the package builds no kernel. The scripts that
make a run's inputs (the metrics' classifiers, the domain perceptual VGG,
the reference-pickle converter) are ``scripts``, each run with ``python -m``.
"""
