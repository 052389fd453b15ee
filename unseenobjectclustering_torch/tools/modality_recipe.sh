#!/usr/bin/env bash
# Train the stage-1 ResNet-34-8s network of each of the paper's other
# input recipes from scratch on procedural synthetic scenes at 240x320 and
# report it beside rgbd_add's (tools/synthetic_recipe.sh): COLOR, DEPTH,
# RGB-D early fusion and RGB-D cat fusion
# (unseenobjectclustering_torch/cfgs/synthetic_240x320_<input>.yml).
# Render the train and test splits once, with the rgbd_add recipe's scene
# count, then per recipe train with --bf16 --device-resident (Adam 2e-4,
# batch 16) and run tools.test_net on the last snapshot over the held-out
# scenes.  One card; run it from the repository's root:
#
#   bash unseenobjectclustering_torch/tools/modality_recipe.sh
#
# The rgbd_add config's TRAIN.SYNNUM scenes an epoch, 10 epochs, 50
# held-out scenes, as the rgbd_add recipe.  Everything it writes goes
# under OUT (output/modalities_240x320 unless OUT is set in the
# environment).
set -euo pipefail

CFGS=unseenobjectclustering_torch/cfgs
SCENES=$(sed -n 's/^ *SYNNUM: *//p' "$CFGS/synthetic_240x320_rgbd_add.yml")
EPOCHS=10
HELD_OUT=50
OUT=${OUT:-output/modalities_240x320}
NET=seg_resnet34_8s_embedding
TOOLS=unseenobjectclustering_torch.tools

nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
mkdir -p "$OUT"
start=$(date +%s)
for split in train test; do
  num=$([ "$split" = train ] && echo "$SCENES" || echo "$HELD_OUT")
  python -m $TOOLS.render_dataset --cache-dir "$OUT/cache" --split "$split" \
    --height 240 --width 320 --num "$num"
done
echo "rendered in $(( $(date +%s) - start )) s"

for input in color depth rgbd_early rgbd_cat; do
  cfg="$CFGS/synthetic_240x320_$input.yml"
  python -m $TOOLS.train_net --cfg "$cfg" --network $NET --solver adam \
    --epochs "$EPOCHS" --bf16 --device-resident --render-cache "$OUT/cache" \
    --resident-limit "$SCENES" --keep 1 --workers 0 \
    --output-dir "$OUT/$input/snapshots" > "$OUT/train_$input.log"
  echo "$input trained in $(( $(date +%s) - start )) s"
  python -m $TOOLS.test_net --cfg "$cfg" --network $NET \
    --dataset synthetic_tabletop_test --dataset_root "$OUT/cache" \
    --pretrained "$OUT/$input/snapshots/$EPOCHS" --max_images "$HELD_OUT" \
    --output-dir "$OUT/$input/test_net" > "$OUT/test_net_$input.log"
  echo "$input, epoch $EPOCHS:"
  grep -E '^(Objects F-measure|Boundary F-measure|obj_detected_075_percentage):' \
    "$OUT/test_net_$input.log" | head -3 || true
done
echo "done in $(( $(date +%s) - start )) s"
