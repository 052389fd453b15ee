#!/usr/bin/env bash
# Train the stage-1 ResNet-34-8s RGB-D network from scratch on procedural
# synthetic scenes at 240x320 and report it: render the train and test
# splits, train with --bf16 --device-resident (Adam 2e-4, batch 16,
# unseenobjectclustering_torch/cfgs/synthetic_240x320_rgbd_add.yml), run
# tools.test_net on the held-out scenes for every kept snapshot, then
# tools.fast_parity_report on the last one.  One card; run it from the
# repository's root:
#
#   bash unseenobjectclustering_torch/tools/synthetic_recipe.sh
#
# The config's TRAIN.SYNNUM scenes an epoch, 10 epochs, 50 held-out
# scenes.  Everything it writes goes under OUT (output/synthetic_240x320
# unless OUT is set in the environment).
set -euo pipefail

CFG=unseenobjectclustering_torch/cfgs/synthetic_240x320_rgbd_add.yml
SCENES=$(sed -n 's/^ *SYNNUM: *//p' "$CFG")
EPOCHS=10
HELD_OUT=50
OUT=${OUT:-output/synthetic_240x320}
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

python -m $TOOLS.train_net --cfg "$CFG" --network $NET --solver adam \
  --epochs "$EPOCHS" --bf16 --device-resident --render-cache "$OUT/cache" \
  --resident-limit "$SCENES" --keep "$EPOCHS" --workers 0 \
  --output-dir "$OUT/snapshots"
echo "trained in $(( $(date +%s) - start )) s"

for epoch in $(ls "$OUT/snapshots" | grep -E '^[0-9]+$' | sort -n); do
  python -m $TOOLS.test_net --cfg "$CFG" --network $NET \
    --dataset synthetic_tabletop_test --dataset_root "$OUT/cache" \
    --pretrained "$OUT/snapshots/$epoch" --max_images "$HELD_OUT" \
    --output-dir "$OUT/test_net/$epoch" > "$OUT/test_net_$epoch.log"
  echo "epoch $epoch:"
  grep -E '^(Objects F-measure|Boundary F-measure|obj_detected_075_percentage):' \
    "$OUT/test_net_$epoch.log" | head -3 || true
done

python -m $TOOLS.fast_parity_report --pretrained "$OUT/snapshots" \
  --cfg "$CFG" --network $NET --scenes "$HELD_OUT" --height 240 --width 320 \
  --render-cache "$OUT/cache" --out "$OUT/fast_parity.md"
echo "done in $(( $(date +%s) - start )) s"
