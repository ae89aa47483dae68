#!/bin/bash
# Matched-seed bf16-vs-fp32 CelebA-128 pair on the card, through the port:
# the stages of scripts/exp_dtype_pair_celeba.sh, each as its port command.
# Two short production-config runs that differ ONLY in compute dtype (same
# default seed, same data, same schedule), with an in-training fid30k
# trajectory (snapshots every 20 kimg) and the final delta. Trajectories are
# mirrored into artifacts/dtype_pair_celeba_digest.json (results/ is not
# kept).
#
# Card-exclusive. Usage: bash inclusivegan_torch/scripts/exp_dtype_pair_celeba.sh [bfloat16 float32]
set -euo pipefail
cd "$(dirname "$0")/../.."

DATA_DIR=${DATA_DIR:-/tmp/exp/datasets}
DATASET=${DATASET:-celeba_synth_30k}
KIMG=${KIMG:-40}
DIGEST=${DIGEST:-artifacts/dtype_pair_celeba_digest.json}

ARMS=("$@")
[ ${#ARMS[@]} -eq 0 ] && ARMS=(bfloat16 float32)
for DT in "${ARMS[@]}"; do
  echo "== dtype arm: $DT =="
  python3 -m inclusivegan_torch.run_training --data-dir "$DATA_DIR" --dataset "$DATASET" \
    --config config-e-Gskip-Dresnet --num-gpus 1 --data-size 30000 \
    --num-epochs 2 --total-kimg "$KIMG" --metrics fid30k \
    --mirror-augment true --init-proj-dim 512 --candidate-batch-size 1024 \
    --lpips-weights /tmp/exp/celeba_perceptual_vgg.npz \
    --network-snapshot-ticks 20 \
    --dtype "$DT" 2>&1 | tail -6
  RUN=$(ls -d results/[0-9]*-stylegan2-"$DATASET"-* | tail -1)
  mv "$RUN" "${RUN}-dtype-${DT}"
  python3 scripts/record_quality_digest.py "${RUN}-dtype-${DT}" \
    --out "$DIGEST" --note "dtype=${DT} matched-seed ${KIMG} kimg"
  git add "$DIGEST" && git commit -q -m "CelebA dtype-pair digest: ${DT} fid trajectory" || true
done
echo "== dtype pair done; digest at $DIGEST =="
