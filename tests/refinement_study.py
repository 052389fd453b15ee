"""Two-stage refinement on weights the port trained, held across the two
packages frame by frame (a study script run on the CPU; it imports both
packages, as the tests do).

    python tests/refinement_study.py train --out DIR
    python tests/refinement_study.py compare --out DIR [--epoch N]

`train` renders the procedural train and test splits with the port's
tools.render_dataset and trains, with the port's tools.train_net on the
CPU, the stage-1 recipe (unseenobjectclustering_torch/cfgs/
synthetic_240x320_rgbd_add.yml, ResNet-34-8s) and the 128^2 crop recipe
(synthetic_crop128_r18_240x320_rgbd_add.yml, ResNet-18-8s), each cut to
--height x --width frames, --scenes scenes and batch --batch, for
--epochs epochs (the last --keep snapshots kept; --resume N continues
both from epoch N).

`compare` exports the two snapshots of epoch --epoch as reference-layout
.pth files ({'model': {'module.' + key}}), runs the port's tools.test_net
(--pretrained_crop, --network_crop seg_resnet18_8s_embedding,
--crop_size 128) and the JAX package's build_segmentor + evaluate_dataset
(its XLA clustering route) on the --frames held-out scenes with the first
seed pinned on both, and prints one JSON line per frame: stage-1 and
refined labels equal, instances, the RoI crops' and the valid crops'
embeddings' largest differences, the crop clustering of both packages on
the port's and on JAX's crop embeddings, the veto, paste order and RoIs
of the JAX stage 2 on the same inputs, and each package's Objects F
before and after refinement; then one SUMMARY line with both packages'
averaged Objects F, Boundary F and %75 before and after refinement.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFGS = os.path.join(REPO, "unseenobjectclustering_torch", "cfgs")
NET, CROP_NET = "seg_resnet34_8s_embedding", "seg_resnet18_8s_embedding"
RECIPES = {"stage1": ("synthetic_240x320_rgbd_add.yml", NET),
           "crop128": ("synthetic_crop128_r18_240x320_rgbd_add.yml",
                       CROP_NET)}
SIDE = 128
KEYS = ("Objects F-measure", "Boundary F-measure",
        "obj_detected_075_percentage")


def tool(name: str, *args: str) -> None:
    subprocess.run([sys.executable, "-m",
                    f"unseenobjectclustering_torch.tools.{name}", *args],
                   cwd=REPO, check=True)


def train(a: argparse.Namespace) -> None:
    import yaml

    cache = os.path.join(a.out, "cache")
    for split, num in (("train", a.scenes), ("test", a.frames)):
        tool("render_dataset", "--cache-dir", cache, "--split", split,
             "--height", str(a.height), "--width", str(a.width), "--num",
             str(num))
    for name, (recipe, net) in RECIPES.items():
        tree = yaml.safe_load(open(os.path.join(CFGS, recipe)))
        tree["TRAIN"].update(SYN_HEIGHT=a.height, SYN_WIDTH=a.width,
                             IMS_PER_BATCH=a.batch, SYNNUM=a.scenes)
        yml = os.path.join(a.out, name + ".yml")
        with open(yml, "w") as f:
            yaml.safe_dump(tree, f)
        snaps = os.path.join(a.out, name)
        tool("train_net", "--cfg", yml, "--network", net, "--solver",
             "adam", "--epochs", str(a.epochs), "--device-resident",
             "--render-cache", cache, "--resident-limit", str(a.scenes),
             "--keep", str(a.keep), "--workers", "0", "--device", "cpu",
             "--output-dir", snaps,
             *(["--resume", os.path.join(snaps, str(a.resume))]
               if a.resume else []))


def compare(a: argparse.Namespace) -> None:
    import jax
    import jax.numpy as jnp
    import numpy as np
    import scipy.io
    import torch

    from unseenobjectclustering_torch import config as tcfg
    from unseenobjectclustering_torch.engine import builder as tbuilder
    from unseenobjectclustering_torch.engine import pipeline as tpipe
    from unseenobjectclustering_torch.tools import test_net
    from unseenobjectclustering_torch.utils.evaluation import (
        multilabel_metrics)
    from unseenobjectclustering_tpu import config as jcfg
    from unseenobjectclustering_tpu.data import factory as jfactory
    from unseenobjectclustering_tpu.engine import builder as jbuilder
    from unseenobjectclustering_tpu.engine import evaluate as jevaluate
    from unseenobjectclustering_tpu.engine.pipeline import (
        _cluster_crops as j_cluster_crops)
    from unseenobjectclustering_tpu.ops import roi as jroi
    from unseenobjectclustering_tpu.ops.train_pipeline import (
        _dense_relabel as j_dense_relabel)
    from unseenobjectclustering_tpu.utils import evaluation as jev

    torch.set_num_threads(a.threads)
    out = a.out
    pths = {}
    for name, (_, net) in RECIPES.items():
        yml = os.path.join(out, name + ".yml")
        cfg = tcfg.Config.from_yaml(yml).replace(MODE="TEST")
        state = tbuilder.load_network_state(
            cfg, net, os.path.join(out, name, str(a.epoch)))
        pths[name] = os.path.join(out, f"{name}_{a.epoch}.pth")
        torch.save({"model": {"module." + k: v for k, v in state.items()}},
                   pths[name])
    stage1_yml = os.path.join(out, "stage1.yml")

    # the port's test_net, every frame's stage 2 recorded
    rec: list[dict] = []
    build = tbuilder.build_segmentor

    def recording(*args, **kwargs):
        seg = build(*args, **kwargs)
        seg._ms_kw = dict(seg._ms_kw, first_index=a.first)
        impl, forward = seg._stage2_impl, seg.model_crop.forward

        def crop_forward(rgb, xyz):
            feats = forward(rgb, xyz)
            rec[-1].update(rgb=rgb.clone(), dep=xyz.clone(),
                           feats=feats.clone())
            return feats

        def stage2(img, labels, xyz, gen, **kw):
            rec.append(dict(img=img.clone(), labels=labels.clone(),
                            xyz=xyz.clone(), kw=kw))
            res = impl(img, labels, xyz, gen, **kw)
            rec[-1]["out"] = [t.clone() for t in res]
            return res

        seg.model_crop.forward = crop_forward
        seg._stage2_impl = stage2
        return seg

    cluster_crops = tpipe._cluster_crops

    def recorded_crops(feats, valid, gen, **kw):
        labels = cluster_crops(feats, valid, gen, **kw)
        rec[-1]["crop_labels"] = labels.clone()
        return labels

    tpipe._cluster_crops = recorded_crops
    test_net.builder.build_segmentor = recording
    port1, portr = test_net.main([
        "--dataset", "synthetic_tabletop_test", "--dataset_root",
        os.path.join(out, "cache"), "--cfg", stage1_yml, "--network", NET,
        "--pretrained", pths["stage1"], "--pretrained_crop",
        pths["crop128"], "--network_crop", CROP_NET, "--crop_size",
        str(SIDE), "--max_images", str(a.frames), "--device", "cpu",
        "--output-dir", os.path.join(out, f"port_{a.epoch}")])

    # JAX: its builder reads the same .pth files
    jc = jcfg.Config.from_yaml(stage1_yml).replace(
        MODE="TEST", TRAIN={"SYN_CROP_SIZE": SIDE},
        **{"CLUSTER.USE_PALLAS": False})
    jseg = jbuilder.build_segmentor(
        jc, NET, pretrained=pths["stage1"], pretrained_crop=pths["crop128"],
        crop_network_name=CROP_NET, depth_threshold=None,
        height=-(-jc.TRAIN.SYN_HEIGHT // 16) * 16,
        width=-(-jc.TRAIN.SYN_WIDTH // 16) * 16)
    jseg._ms_kw = dict(jseg._ms_kw, first_index=a.first)
    ds = jfactory.get_dataset("synthetic_tabletop_test", jc,
                              path=os.path.join(out, "cache"))
    jax1, jaxr = jevaluate.evaluate_dataset(
        ds, jseg, output_dir=os.path.join(out, f"jax_{a.epoch}"),
        save_results=True, max_images=a.frames, verbose=False)

    rows = []
    num_seeds = int(jseg._ms_kw["num_seeds"])
    for i in range(a.frames):
        p, j = (scipy.io.loadmat(os.path.join(out, f"{d}_{a.epoch}",
                                              f"{i:06d}.mat"))
                for d in ("port", "jax"))
        gt = np.asarray(ds[i]["label"])
        r = rec[i]
        img, labels, xyz = (r[k].numpy() for k in ("img", "labels", "xyz"))
        m = r["kw"]["max_instances"]
        crops = jroi.crop_rois(
            jnp.asarray(img), j_dense_relabel(jnp.asarray(labels),
                                              max_id=num_seeds),
            jnp.asarray(xyz), max_instances=m, crop_size=SIDE)
        valid = np.asarray(crops.valid)
        jfeats = np.asarray(jseg.model_crop.apply(
            jseg.variables_crop, crops.rgb_crops, crops.depth_crops,
            train=False))
        pfeats = r["feats"].numpy()
        keys = jax.random.split(jax.random.PRNGKey(0), m)
        plab = r["crop_labels"].numpy()
        on_port, on_jax = (np.asarray(j_cluster_crops(
            jnp.asarray(f), crops.valid, keys, **jseg._ms_kw))
            for f in (pfeats, jfeats))
        veto, order, rois, _ = (np.asarray(t) for t in jseg._stage2(
            jseg.variables_crop, jnp.asarray(img), jnp.asarray(labels),
            jnp.asarray(xyz), jax.random.PRNGKey(0), has_depth=True,
            max_instances=m))
        pveto, porder, prois, _ = (t.numpy() for t in r["out"])
        fin = np.isfinite(order)
        row = dict(
            frame=i,
            stage1_equal=bool(np.array_equal(p["labels"], j["labels"])),
            refined_equal=bool(np.array_equal(p["labels_refined"],
                                              j["labels_refined"])),
            instances=int((np.unique(p["labels"]) > 0).sum()),
            refined_instances=int((np.unique(p["labels_refined"]) > 0).sum()),
            gt_objects=int((np.unique(gt) > 0).sum()),
            valid=int(valid.sum()),
            rgb_crop_err=float(np.abs(r["rgb"].numpy()
                                      - np.asarray(crops.rgb_crops)).max()),
            depth_crop_err=float(np.abs(
                r["dep"].numpy() - np.asarray(crops.depth_crops)).max()),
            crop_embedding_err=float(np.abs(pfeats[valid]
                                            - jfeats[valid]).max())
            if valid.any() else 0.0,
            crop_label_pixels_vs_jax_on_port_embeddings=int(
                (plab != on_port).sum()),
            crop_label_pixels_vs_jax_on_its_embeddings=int(
                (plab != on_jax).sum()),
            veto_pixels_vs_jax_stage2=int((pveto != veto).sum()),
            order_key_err=float(np.abs(porder[fin] - order[fin]).max())
            if fin.any() else 0.0,
            order_same=bool(np.array_equal(np.argsort(-porder, kind="stable"),
                                           np.argsort(-order, kind="stable"))),
            rois_equal=bool(np.array_equal(prois, rois)),
            port_F=multilabel_metrics(p["labels"], gt)["Objects F-measure"],
            port_F_refined=multilabel_metrics(p["labels_refined"], gt)[
                "Objects F-measure"],
            jax_F=jev.multilabel_metrics(j["labels"], gt)["Objects F-measure"],
            jax_F_refined=jev.multilabel_metrics(j["labels_refined"], gt)[
                "Objects F-measure"])
        rows.append(row)
        print(json.dumps(row))
    summary = dict(
        epoch=a.epoch, frames=a.frames, first_index=a.first,
        port_stage1={k: port1[k] for k in KEYS},
        port_refined={k: portr[k] for k in KEYS},
        jax_stage1={k: jax1[k] for k in KEYS},
        jax_refined={k: jaxr[k] for k in KEYS},
        metric_dicts_equal=[port1 == jax1, portr == jaxr],
        frames_stage1_equal=sum(r["stage1_equal"] for r in rows),
        frames_refined_equal=sum(r["refined_equal"] for r in rows),
        max_crop_embedding_err=max(r["crop_embedding_err"] for r in rows),
        instances=[r["instances"] for r in rows],
        refined_instances=[r["refined_instances"] for r in rows],
        gt_objects=[r["gt_objects"] for r in rows])
    print("SUMMARY " + json.dumps(summary))


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    sub = parser.add_subparsers(dest="step", required=True)
    t = sub.add_parser("train")
    t.add_argument("--out", required=True)
    t.add_argument("--height", type=int, default=120)
    t.add_argument("--width", type=int, default=160)
    t.add_argument("--scenes", type=int, default=512)
    t.add_argument("--frames", type=int, default=16)
    t.add_argument("--batch", type=int, default=8)
    t.add_argument("--epochs", type=int, default=24)
    t.add_argument("--resume", type=int, default=0)
    t.add_argument("--keep", type=int, default=2)
    c = sub.add_parser("compare")
    c.add_argument("--out", required=True)
    c.add_argument("--epoch", type=int, default=24)
    c.add_argument("--frames", type=int, default=16)
    c.add_argument("--first", type=int, default=5)
    c.add_argument("--threads", type=int, default=4)
    a = parser.parse_args(argv)
    os.makedirs(a.out, exist_ok=True)
    (train if a.step == "train" else compare)(a)


if __name__ == "__main__":
    sys.path.insert(0, REPO)
    main()
