"""The slice end to end: tokens_grid.run_video in both packages on one
synthetic 6-frame 64-px video with 3 prompts on 2 frames, fp32 compute,
shared weights (state_dict_from_jax_params). Census and dedup decisions
must be equal, masklets within 0.1% of pixels per track, tokens within
1e-4."""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sola_tpu.core import rle as jrle
from sola_tpu.data import tracks as jtracks
from sola_tpu.trackgen import tokens_grid as jtokens
from sola_tpu.trackgen.sam2.model import SAM2Config as JConfig
from sola_tpu.trackgen.sam2.model import SAM2Model as JModel
from sola_tpu.trackgen.sam2.video import SAM2VideoPredictor as JPredictor
from sola_torch.core import rle as trle
from sola_torch.data import tracks as ttracks
from sola_torch.trackgen import tokens_grid as ttokens
from sola_torch.trackgen.sam2.convert import state_dict_from_jax_params
from sola_torch.trackgen.sam2.model import SAM2Config, SAM2Model
from sola_torch.trackgen.sam2.video import SAM2VideoPredictor

T, S = 6, 64
VID = "vid0"


def make_frames(seed=0):
    rng = np.random.default_rng(seed)
    frames = []
    for t in range(T):
        f = (rng.random((S, S, 3)) * 40).astype(np.uint8)
        x = 6 + 3 * t
        f[10:28, x:x + 14] = (220, 80, 40)
        f[38:56, 50 - 3 * t:62 - 3 * t] = (40, 200, 90)
        frames.append(f)
    return frames


def prompt_masks():
    a = np.zeros((S, S), np.uint8)
    a[10:28, 6:20] = 1
    b = np.zeros((S, S), np.uint8)
    b[38:56, 50:62] = 1
    c = np.zeros((S, S), np.uint8)
    c[10:28, 18:32] = 1            # object a at frame 4
    return [(0, 0, a), (1, 0, b), (2, 4, c)]


def write_prompts(path):
    prompts = [{"segmentation": jrle.encode(m), "stability_score": 0.97,
                "area": int(m.sum()), "area_ratio": float(m.mean()),
                "frame_idx": f, "prompt_id": pid}
               for pid, f, m in prompt_masks()]
    with open(path, "w") as fh:
        json.dump({"video_id": VID, "bin_size": 4, "prompt_masks": prompts},
                  fh)


@pytest.fixture(scope="module")
def predictors():
    torch.set_num_threads(2)
    jcfg = JConfig.tiny_test(image_size=S)
    jmodel = JModel(jcfg)
    variables = jmodel.init(jax.random.PRNGKey(0),
                            jnp.zeros((1, S, S, 3), jnp.float32))
    variables = jax.tree_util.tree_map(np.asarray, variables)
    jpred = JPredictor(jmodel, variables, obj_batch=2,
                       feature_dtype=jnp.float32, compute_dtype=jnp.float32)
    cfg = SAM2Config.tiny_test(image_size=S)
    model = SAM2Model(cfg)
    model.load_state_dict(state_dict_from_jax_params(variables, cfg),
                          strict=True)
    tpred = SAM2VideoPredictor(model, obj_batch=2,
                               feature_dtype=torch.float32,
                               compute_dtype=torch.float32)
    return jpred, tpred


def _strip(census):
    return {k: v for k, v in census.items() if k not in ("time", "fps")}


def _tracks(tracks_mod, rle_mod, root):
    recs = tracks_mod.load_track_records(root, "grid_tracks", "mevis",
                                         "valid_u", VID, use_index=False)
    out = {}
    for rec in recs:
        with open(rec.masklet_path) as fh:
            info = json.load(fh)
        out[rec.sam2_anno_id] = (rle_mod.decode_masklet(info["rle"]),
                                 np.load(rec.token_path))
    return out


def _assert_same_tracks(jt, tt):
    assert sorted(jt) == sorted(tt)
    for pid in jt:
        jm, jtok = jt[pid]
        tm, ttok = tt[pid]
        assert jm.shape == tm.shape == (T, S, S)
        assert ttok.shape == jtok.shape == (T, 32)
        assert np.isfinite(ttok).all()
        frac = (jm != tm).reshape(T, -1).mean(axis=1)
        assert frac.max() <= 1e-3, (pid, frac)
        np.testing.assert_allclose(ttok, jtok, atol=1e-4, rtol=0)


def test_run_video_matches_jax(tmp_path, predictors):
    jpred, tpred = predictors
    frames = make_frames()
    prompt_path = str(tmp_path / f"{VID}.json")
    write_prompts(prompt_path)
    results = {}
    for name, pred, tok_mod in (("jax", jpred, jtokens),
                                ("torch", tpred, ttokens)):
        root = str(tmp_path / name)
        out_root = os.path.join(root, "grid_tracks", "mevis", "valid_u")
        census = tok_mod.run_video(
            pred, VID, None, prompt_path, out_root, "mevis", "valid_u",
            bin_size=4, batch_size=2, state=pred.init_state(frames),
            log=lambda s: None)
        results[name] = (census, root)
    jc, jroot = results["jax"]
    tc, troot = results["torch"]
    assert _strip(tc) == _strip(jc)
    assert tc["n_tracked"] >= 2
    _assert_same_tracks(_tracks(jtracks, jrle, jroot),
                        _tracks(ttracks, trle, troot))


def test_predictor_outputs_match_jax(predictors):
    """Per-frame masks, small masklets and tokens of one bidirectional
    batch, prompted mid-video (both passes run)."""
    jpred, tpred = predictors
    frames = make_frames(1)
    outs = {}
    for name, pred in (("jax", jpred), ("torch", tpred)):
        state = pred.init_state(frames)
        pred.reset_state(state)
        for pid, _, m in prompt_masks()[:2]:
            pred.add_new_mask(state, 2, pid, m)
        masks = {}
        for rev in (False, True):
            for fidx, ids, m in pred.propagate_in_video(
                    state, reverse=rev, output_mode="masks"):
                masks[fidx] = np.asarray(m)
        small = pred.get_small_masklets(state)
        small = small.numpy() if torch.is_tensor(small) else np.asarray(
            small)
        outs[name] = (masks, small, pred.get_output_tokens(state))
    (jm, js, jt), (tm, ts, tt) = outs["jax"], outs["torch"]
    assert sorted(jm) == sorted(tm) == list(range(T))
    for f in range(T):
        assert (jm[f] != tm[f]).mean() <= 1e-3
        np.testing.assert_allclose(tt[f], jt[f], atol=1e-4, rtol=0)
    assert js.shape == ts.shape == (T, 2, 960, 540)
    assert (js != ts).mean() <= 1e-3


def test_main_cli_with_jpeg_frames(tmp_path, predictors):
    """tokens_grid.main over a MeViS-layout workspace of JPEG frames, with
    the predictor factory injected, in both packages."""
    from PIL import Image
    jpred, tpred = predictors
    data_dir = tmp_path / "datasets" / "mevis" / "valid_u"
    frames_dir = data_dir / "JPEGImages" / VID
    frames_dir.mkdir(parents=True)
    for t, f in enumerate(make_frames(2)):
        Image.fromarray(f).save(frames_dir / f"{t:05d}.jpg")
    meta = {"videos": {VID: {"frames": [f"{t:05d}" for t in range(T)],
                             "expressions": {"0": {"exp": "a thing",
                                                   "anno_id": [0]}}}}}
    (data_dir / "meta_expressions.json").write_text(json.dumps(meta))
    censuses = {}
    for name, pred, tok_mod in (("jax", jpred, jtokens),
                                ("torch", tpred, ttokens)):
        out = tmp_path / name
        prompt_dir = out / "sam2_prompts" / "grid_prompts" / "mevis" / \
            "valid_u"
        prompt_dir.mkdir(parents=True)
        write_prompts(str(prompt_dir / f"{VID}.json"))
        argv = ["--data_root", str(tmp_path), "--output_root", str(out),
                "--batch_size", "2", "--prefetch_videos", "1"]
        if name == "torch":
            argv += ["--device", "cpu"]
        tok_mod.main(argv, predictor_factory=lambda p=pred: p)
        with open(out / "sam2_tracks" / "grid_tracks" / "mevis" / "valid_u"
                  / "runtime_info_4.json") as fh:
            censuses[name] = json.load(fh)[VID]
    assert _strip(censuses["torch"]) == _strip(censuses["jax"])
    _assert_same_tracks(
        _tracks(jtracks, jrle, str(tmp_path / "jax" / "sam2_tracks")),
        _tracks(ttracks, trle, str(tmp_path / "torch" / "sam2_tracks")))

