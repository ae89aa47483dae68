#!/bin/bash
# Rebuild every durable artifact of the stacked-MNIST mode-coverage
# experiment, through the port: the stages of
# scripts/rebuild_exp_artifacts.sh, each as its port command. /tmp does not
# reliably survive restarts, so the small trained weights are also
# mirrored into the git repo under artifacts/; this script restores from
# those copies when present and only retrains what is missing.
#
# Usage: bash inclusivegan_torch/scripts/rebuild_exp_artifacts.sh
# Card use: the classifier and the perceptual VGG training, one after the
# other. Run it BEFORE starting the trainer.
set -euo pipefail
cd "$(dirname "$0")/../.."
REPO=$PWD
EXP=/tmp/exp
mkdir -p $EXP/datasets

# 1. synthetic MNIST idx files (CPU)
if [ ! -f $EXP/mnist/train-images-idx3-ubyte ]; then
  python3 scripts/make_synthetic_mnist.py --out $EXP/mnist --num-images 60000
fi

# 2. 240k stacked-MNIST TFRecord pyramid (CPU)
if [ ! -f $EXP/datasets/stacked_synth_240k/stacked_synth_240k-rxx.labels ]; then
  python3 -m inclusivegan_torch.dataset_tool create_mnistrgb \
    $EXP/datasets/stacked_synth_240k $EXP/mnist --num_images 240000
fi

# 2b. 60k pyramid for the matched-seed arms (exp_matched_arms.sh)
if [ ! -f $EXP/datasets/stacked_synth_60k/stacked_synth_60k-rxx.labels ]; then
  python3 -m inclusivegan_torch.dataset_tool create_mnistrgb \
    $EXP/datasets/stacked_synth_60k $EXP/mnist --num_images 60000
fi

# 3. mode_counts/KL classifier (restore from repo mirror, else train)
if [ ! -f $EXP/stacked_mnist_classifier.npz ]; then
  if [ -f $REPO/artifacts/stacked_mnist_classifier.npz ]; then
    cp $REPO/artifacts/stacked_mnist_classifier.npz $EXP/
  else
    python3 -m inclusivegan_torch.scripts.train_mnist_classifier --mnist-dir $EXP/mnist \
      --out $EXP/stacked_mnist_classifier.npz
  fi
fi

# 4. domain-trained perceptual VGG anchor (restore, else train on the card)
if [ ! -f $EXP/perceptual_vgg.npz ]; then
  if [ -f $REPO/artifacts/perceptual_vgg.npz ]; then
    cp $REPO/artifacts/perceptual_vgg.npz $EXP/
  else
    python3 -m inclusivegan_torch.scripts.train_perceptual_vgg --data-dir $EXP/datasets \
      --dataset stacked_synth_240k --out $EXP/perceptual_vgg.npz
  fi
fi

# 5. mirror small weights back into the repo for the next wipe
mkdir -p $REPO/artifacts
for f in stacked_mnist_classifier.npz perceptual_vgg.npz; do
  if [ ! -f $REPO/artifacts/$f ]; then cp $EXP/$f $REPO/artifacts/; fi
done

echo "rebuild_exp_artifacts: all artifacts present under $EXP"
ls -la $EXP $EXP/datasets/stacked_synth_240k | sed -n '1,40p'
