"""inclusivegan_torch: the PyTorch/CUDA port of inclusivegan_tpu for one
NVIDIA H100 (sm_90a).

Serving: ``run_generator.generate_images`` loads a ``network_snapshot.v1``
pickle (``snapshot.load_snapshot``) and runs the Gs (mapping, truncation,
synthesis). Training, one iteration: ``snapshot.load_train_state``,
``training.imle.IMLEOrchestrator`` and ``training.train_step.make_train_step``
(G main, path-length reg, D main with the Gs EMA, R1). Both run through two
hand-written CUDA kernels, bias+lrelu and upfirdn2d (``ops/csrc``), with
their backward passes. Entry points run on ``cuda`` unless
the caller passes ``device="cpu"``; on CPU tensors every op takes its plain
PyTorch version. Importing the package builds no kernel.
"""
