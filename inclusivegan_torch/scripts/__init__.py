"""The port's counterparts of the repository's ``scripts/`` that make a run's
inputs, each run as ``python -m inclusivegan_torch.scripts.<name>`` with the
flags and defaults of ``python scripts/<name>.py``:

- ``train_mnist_classifier``: the stacked-MNIST mode classifier
  (``mode_counts``, ``KL``) from MNIST idx files;
- ``train_attr_classifier``: the CelebA 40-attribute classifier (``ls``,
  the minority filter) from a TFRecord set with 40 labels;
- ``train_perceptual_vgg``: the domain perceptual VGG16 and its LPIPS
  calibration, the npz of ``--lpips-weights``;
- ``convert_reference_pkl``: a ``dump_reference_vars.py`` npz to a
  ``network_snapshot.v1`` pickle.

They write the files the JAX package's scripts write, which both packages
read. The trainers run on ``cuda`` unless ``--device cpu`` is passed, in
float32 with TF32 off, as ``run_training`` trains.
"""
