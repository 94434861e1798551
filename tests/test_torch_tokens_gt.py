"""GT-prompted tracks in both packages at tiny size, fp32 on the CPU, with
shared weights: gt_seed_units, the port's run_videos_packed_gt one video a
call at one slot a round (the CLI's default) against JAX's run_video (one
slot a pass) and packed at 4 slots, and main on a MeViS and a Ref-YTVOS
layout of JPEG frames. The videos are
tests/test_packed.py::test_gt_packed_matches_sequential's: one object
re-appears (two onsets, two tracks) and one first appears at frame 3, so
its packed slot has an onset above 0 beside longer slots. Port against
JAX: per-frame mask disagreement <= 1e-3, tokens within 1e-4. Port at 4
slots and several videos a pack against the port at 1 slot and one video:
RLE equal, tokens and prec/rec/iou within 1e-5."""

import json
import os

import numpy as np
import pytest
import torch

from sola_tpu.core import rle as jrle
from sola_tpu.trackgen import tokens_gt as jtokens_gt
from sola_torch.core import rle as trle
from sola_torch.trackgen import tokens_gt as ttokens_gt
from test_gt_formats import save_palette_png
from test_packed import make_video
from test_torch_packed import (PIX_FRAC, TOK_ATOL, jax_variables,
                               predictor_pair)

GT_ATOL = 1e-5


def gt_obj(t, hw, y0, y1, x0, x1, absent=()):
    m = np.zeros((t,) + hw, np.uint8)
    for f in range(t):
        if f not in absent:
            x = (x0 + 2 * f) % max(hw[1] - (x1 - x0), 1)
            m[f, y0:y1, x:x + (x1 - x0)] = 1
    return m


VIDEOS = [
    ("vidA", 5, (48, 72), 13, {
        "1": gt_obj(5, (48, 72), 6, 20, 4, 14),
        "2": gt_obj(5, (48, 72), 24, 40, 30, 42),
    }),
    ("vidB", 7, (40, 56), 29, {
        "3": gt_obj(7, (40, 56), 6, 20, 4, 14),
        # absent at frame 2: two appearance onsets, two tracks
        "4": gt_obj(7, (40, 56), 22, 36, 20, 32, absent=(2,)),
        # absent at frames 0-2: one onset at frame 3
        "5": gt_obj(7, (40, 56), 8, 22, 30, 44, absent=(0, 1, 2)),
    }),
]


@pytest.fixture(scope="module")
def predictors():
    """{obj_batch: (JAX, port)} predictor pairs on one set of weights:
    1 is the CLI's sequential width, 4 the packed one."""
    torch.set_num_threads(2)
    model, variables = jax_variables()
    return {b: predictor_pair(model, variables, b) for b in (1, 4)}


def collect(root):
    out = {}
    for dirpath, _, files in os.walk(root):
        for fn in sorted(files):
            p = os.path.join(dirpath, fn)
            rel = os.path.relpath(p, root)
            if fn.endswith(".json"):
                with open(p) as f:
                    out[rel] = json.load(f)
            elif fn.endswith(".npy"):
                out[rel] = np.load(p)
    return out


def metric_values(info):
    return np.asarray([info[k][g] for k in ("precision", "recall", "iou")
                       for g in sorted(info.get(k, {}))], float)


def assert_same_artifacts(ref, got, rle_mod, *, exact_rle, tok_atol,
                          metric_atol):
    assert sorted(ref) == sorted(got)
    # 6 seeds (object 4 re-appears) x (json + npy) + nothing else
    assert len(ref) == 12
    for rel in ref:
        if rel.endswith(".npy"):
            assert got[rel].shape == ref[rel].shape
            np.testing.assert_allclose(got[rel], ref[rel], atol=tok_atol,
                                       rtol=0)
            continue
        a, b = ref[rel], got[rel]
        assert a["prompt_type"] == b["prompt_type"] == "GT MASK"
        assert a["anno_id"] == b["anno_id"]
        if exact_rle:
            assert a["rle"] == b["rle"], rel
        else:
            ma = rle_mod.decode_masklet(a["rle"])
            mb = rle_mod.decode_masklet(b["rle"])
            assert ma.shape == mb.shape
            frac = (ma != mb).reshape(ma.shape[0], -1).mean(axis=1)
            assert frac.max() <= PIX_FRAC, (rel, frac)
        assert sorted(a.get("iou", {})) == sorted(b.get("iou", {}))
        np.testing.assert_allclose(metric_values(b), metric_values(a),
                                   atol=metric_atol, rtol=0)


def encoded(pred):
    return {vid: pred.init_state(make_video(t, hw, seed=seed))
            for vid, t, hw, seed, _ in VIDEOS}


def run_sequential(pred, root):
    """sola_tpu's run_video: one seed a pass."""
    states = encoded(pred)
    return {vid: jtokens_gt.run_video(pred, states[vid], vid, gts, t, root,
                                      "mevis", "train",
                                      save_prec_rec_iou=True,
                                      log=lambda s: None)
            for vid, t, hw, _seed, gts in VIDEOS}


def run_packed(mod, pred, root, *, videos_a_call=len(VIDEOS)):
    states = encoded(pred)
    items = [{"video_id": vid, "state": states[vid], "gt_masklets": gts,
              "n_frames": t} for vid, t, hw, _seed, gts in VIDEOS]
    census = {}
    for i in range(0, len(items), videos_a_call):
        census.update(mod.run_videos_packed_gt(
            pred, items[i:i + videos_a_call], root, "mevis", "train",
            save_prec_rec_iou=True, log=lambda s: None))
    return census


def untimed(runtime_info):
    """runtime_info without its wall-clock field."""
    return {v: {k: {f: x for f, x in e.items() if f != "time"}
                for k, e in d.items()} for v, d in runtime_info.items()}


def assert_census(census):
    for vid, t, _hw, _seed, gts in VIDEOS:
        units = ttokens_gt.gt_seed_units(gts)
        assert sorted(census[vid], key=int) == [str(u[0]) for u in units]
        for out_id, gt_anno_id, seed in units:
            entry = census[vid][str(out_id)]
            assert entry["gt_anno_id"] == str(gt_anno_id)
            assert entry["seed_frame"] == seed["frame_idx"]
            assert entry["n_frames"] == t


def test_gt_seed_units_match_jax():
    for _vid, _t, _hw, _seed, gts in VIDEOS:
        ju = jtokens_gt.gt_seed_units(gts)
        tu = ttokens_gt.gt_seed_units(gts)
        assert [(o, g, s["frame_idx"]) for o, g, s in tu] == \
            [(o, g, s["frame_idx"]) for o, g, s in ju]
        for (_, _, a), (_, _, b) in zip(ju, tu):
            np.testing.assert_array_equal(a["mask"], b["mask"])
    onsets = [s["frame_idx"] for _, g, s in
              ttokens_gt.gt_seed_units(VIDEOS[1][4])]
    assert onsets == [0, 0, 3, 3]


def test_run_video_matches_jax(tmp_path, predictors):
    """The port's default route (one video a call, one slot a round)
    against sola_tpu's run_video."""
    jpred, tpred = predictors[1]
    jc = run_sequential(jpred, str(tmp_path / "jax"))
    tc = run_packed(ttokens_gt, tpred, str(tmp_path / "torch"),
                    videos_a_call=1)
    assert_census(tc)
    assert untimed(tc) == untimed(jc)
    assert_same_artifacts(collect(str(tmp_path / "jax")),
                          collect(str(tmp_path / "torch")), trle,
                          exact_rle=False, tok_atol=TOK_ATOL,
                          metric_atol=PIX_FRAC)


def test_packed_gt_matches_sequential(tmp_path, predictors):
    """Packed rounds (obj_batch 4, both videos in one pack: the 6 seeds
    take a full round and a round of 2 slots and 2 padding) against the
    pack width 1 (obj_batch 1, one video a call: one seed a round), both
    in the port."""
    _, seq_pred = predictors[1]
    _, pk_pred = predictors[4]
    run_packed(ttokens_gt, seq_pred, str(tmp_path / "seq"), videos_a_call=1)
    census = run_packed(ttokens_gt, pk_pred, str(tmp_path / "pk"))
    assert_census(census)
    assert_same_artifacts(collect(str(tmp_path / "seq")),
                          collect(str(tmp_path / "pk")), trle,
                          exact_rle=True, tok_atol=GT_ATOL,
                          metric_atol=GT_ATOL)


def test_packed_gt_matches_jax(tmp_path, predictors):
    jpred, tpred = predictors[4]
    jc = run_packed(jtokens_gt, jpred, str(tmp_path / "jax"))
    tc = run_packed(ttokens_gt, tpred, str(tmp_path / "torch"))
    assert untimed(tc) == untimed(jc)
    assert_same_artifacts(collect(str(tmp_path / "jax")),
                          collect(str(tmp_path / "torch")), trle,
                          exact_rle=False, tok_atol=TOK_ATOL,
                          metric_atol=PIX_FRAC)


def write_train_split(root, dataset):
    """A train split of VIDEOS on JPEG frames: MeViS's
    meta_expressions.json and mask_dict.json (GT objects keyed by anno id),
    or Ref-YTVOS's meta_expressions/train/meta_expressions.json and
    palette-PNG Annotations (GT objects keyed by palette index)."""
    from PIL import Image
    data_dir = root / "datasets" / dataset / "train"
    meta, mask_dict = {"videos": {}}, {}
    for vid, t, hw, seed, gts in VIDEOS:
        frames_dir = data_dir / "JPEGImages" / vid
        frames_dir.mkdir(parents=True)
        for i, f in enumerate(make_video(t, hw, seed=seed)):
            Image.fromarray(f).save(frames_dir / f"{i:05d}.jpg")
        key = "anno_id" if dataset == "mevis" else "obj_id"
        meta["videos"][vid] = {
            "frames": [f"{i:05d}" for i in range(t)],
            "expressions": {str(e): {"exp": f"object {g}",
                                     key: [int(g)] if key == "anno_id"
                                     else g}
                            for e, g in enumerate(gts)}}
        if dataset == "mevis":
            for g, m in gts.items():
                mask_dict[g] = [jrle.encode(f) if f.any() else None
                                for f in m]
            continue
        anno_dir = data_dir / "Annotations" / vid
        anno_dir.mkdir(parents=True)
        for i in range(t):
            index = np.zeros(hw, np.uint8)
            for g, m in gts.items():
                index[m[i] > 0] = int(g)
            save_palette_png(index, anno_dir / f"{i:05d}.png")
    if dataset == "mevis":
        (data_dir / "meta_expressions.json").write_text(json.dumps(meta))
        (data_dir / "mask_dict.json").write_text(json.dumps(mask_dict))
    else:
        meta_dir = root / "datasets" / dataset / "meta_expressions" / "train"
        meta_dir.mkdir(parents=True)
        (meta_dir / "meta_expressions.json").write_text(json.dumps(meta))


@pytest.mark.parametrize("dataset", ["mevis", "ref-ytbvos"])
def test_main_mevis_layout(tmp_path, predictors, dataset):
    """tokens_gt.main at its defaults in both packages and --video_pack 2
    in the port, on JPEG frames of a MeViS or a Ref-YTVOS layout: the same
    artifact set and runtime_info."""
    write_train_split(tmp_path, dataset)
    argv = ["--data_root", str(tmp_path), "--save_prec_rec_iou",
            "--dataset", dataset]
    runs = (("jax", jtokens_gt, predictors[1][0], []),
            ("seq", ttokens_gt, predictors[1][1], ["--device", "cpu"]),
            ("pk", ttokens_gt, predictors[4][1],
             ["--device", "cpu", "--video_pack", "2"]))
    infos = {}
    for name, mod, pred, extra in runs:
        out = tmp_path / name
        mod.main(argv + ["--output_root", str(out)] + extra,
                 predictor_factory=lambda p=pred: p)
        with open(out / "sam2_tracks" / "gt_tracks" / dataset / "train"
                  / "runtime_info.json") as fh:
            infos[name] = json.load(fh)
    assert untimed(infos["seq"]) == untimed(infos["jax"]) == \
        untimed(infos["pk"])
    assert sorted(infos["seq"]) == ["vidA", "vidB"]
    # object 4's second onset and object 5's only one, both at frame 3
    assert [(e["gt_anno_id"], e["seed_frame"])
            for _, e in sorted(infos["seq"]["vidB"].items())] == [
        ("3", 0), ("4", 0), ("4", 3), ("5", 3)]
    arts = {name: collect(str(tmp_path / name / "sam2_tracks"))
            for name, *_ in runs}
    for a in arts.values():
        a.pop(os.path.join("gt_tracks", dataset, "train",
                           "runtime_info.json"))
    assert_same_artifacts(arts["jax"], arts["seq"], trle, exact_rle=False,
                          tok_atol=TOK_ATOL, metric_atol=PIX_FRAC)
    assert_same_artifacts(arts["seq"], arts["pk"], trle, exact_rle=True,
                          tok_atol=GT_ATOL, metric_atol=GT_ATOL)
    # a second run resumes: every video is in runtime_info, nothing reruns
    path = tmp_path / "seq" / "sam2_tracks" / "gt_tracks" / dataset / \
        "train" / "runtime_info.json"
    before = os.path.getmtime(path)
    ttokens_gt.main(argv + ["--output_root", str(tmp_path / "seq"),
                            "--device", "cpu"],
                    predictor_factory=lambda: predictors[1][1])
    assert os.path.getmtime(path) == before
