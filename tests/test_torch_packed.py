"""Cross-video packed propagation in both packages at tiny size, fp32 on
the CPU, with shared weights (state_dict_from_jax_params): run_round,
generate_tracks_packed, tokens_grid.main --video_pack and
run_expressions_packed against the JAX package's, and the port's packed path
against its own sequential path. Port against JAX: per-frame mask
disagreement <= 1e-3 and tokens within 1e-4 (tests/test_torch_tokens_grid.py
limits). Port packed against port sequential: tests/test_packed.py's bounds
(mask disagreement < 1e-4, tokens within 1e-4).

tests/test_packed.py's first video is 48x72 and downscales in width to
SAM2's 64, where the two packages' antialiased resizes differ in last bits
and the uint8 truncation turns that into a gray level (ROADMAP queue 3;
tests/test_torch_amg.py). The port's predictor here takes such a frame at
the model size from jax.image.resize (``ReferenceResize``); every frame
that upscales on both axes goes through the port's own resize, which then
matches JAX's bit for bit."""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sola_tpu.core import rle as jrle
from sola_tpu.data import tracks as jtracks
from sola_tpu.trackgen import engine as jengine
from sola_tpu.trackgen import packed_engine as jpacked_engine
from sola_tpu.trackgen import tokens_gdino as jtokens_gdino
from sola_tpu.trackgen import tokens_grid as jtokens_grid
from sola_tpu.trackgen.sam2 import packed as jpacked
from sola_tpu.trackgen.sam2.model import SAM2Config as JConfig
from sola_tpu.trackgen.sam2.model import SAM2Model as JModel
from sola_tpu.trackgen.sam2.video import SAM2VideoPredictor as JPredictor
from sola_torch.core import rle as trle
from sola_torch.data import tracks as ttracks
from sola_torch.trackgen import engine as tengine
from sola_torch.trackgen import packed_engine as tpacked_engine
from sola_torch.trackgen import tokens_gdino as ttokens_gdino
from sola_torch.trackgen import tokens_grid as ttokens_grid
from sola_torch.trackgen.sam2 import packed as tpacked
from sola_torch.trackgen.sam2.convert import state_dict_from_jax_params
from sola_torch.trackgen.sam2.model import SAM2Config, SAM2Model
from sola_torch.trackgen.sam2.video import SAM2VideoPredictor, _load_frames
from test_packed import VIDEOS, box_mask, build_prompts, make_video

S = 64
PIX_FRAC = 1e-3       # port against JAX, per frame
PACK_FRAC = 1e-4      # port packed against port sequential, per track
TOK_ATOL = 1e-4


_jax_resize = jax.jit(lambda raw: jax.image.resize(
    raw.astype(jnp.float32), (S, S, 3), method="linear").astype(jnp.uint8))


class ReferenceResize(SAM2VideoPredictor):
    """The port's video predictor; a frame that downscales on an axis
    reaches it at the model size from jax.image.resize, as the JAX
    predictor resizes it. The rest of the encode and all tracking are the
    port's."""

    def init_state(self, frames, video_path=None):
        if video_path is not None:
            frames = _load_frames(video_path)
        hw = tuple(frames[0].shape[:2])
        if max(hw) > S:
            frames = [np.asarray(_jax_resize(f)) for f in frames]
        state = super().init_state(frames)
        state.orig_hw = hw
        return state


def jax_variables(seed: int = 0):
    model = JModel(JConfig.tiny_test(image_size=S))
    variables = jax.jit(model.init)(jax.random.PRNGKey(seed),
                                    jnp.zeros((1, S, S, 3), jnp.float32))
    return model, jax.tree_util.tree_map(np.asarray, variables)


def predictor_pair(model, variables, obj_batch: int):
    """(JAX, port) fp32 video predictors on the same weights."""
    jpred = JPredictor(model, variables, obj_batch=obj_batch,
                       feature_dtype=jnp.float32, compute_dtype=jnp.float32,
                       scan_chunk=4)
    cfg = SAM2Config.tiny_test(image_size=S)
    tmodel = SAM2Model(cfg)
    tmodel.load_state_dict(state_dict_from_jax_params(variables, cfg),
                           strict=True)
    tpred = ReferenceResize(tmodel, obj_batch=obj_batch,
                            feature_dtype=torch.float32,
                            compute_dtype=torch.float32)
    return jpred, tpred


@pytest.fixture(scope="module")
def predictors():
    torch.set_num_threads(2)
    return predictor_pair(*jax_variables(), obj_batch=4)


def assert_close_masks(a, b, frac):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    d = (a != b).reshape(a.shape[0], -1).mean(axis=1) if a.ndim == 3 \
        else np.asarray([(a != b).mean()])
    assert d.max() <= frac, d


def round_plan():
    """4 slots over the three videos, cond frames 0-4: video 0 at frame 2,
    video 1 at 1, video 2 at 0 and 4 (the onset-4 slot and the 4-frame
    video are packed beside the 9-frame one, so both have idle steps)."""
    video = np.asarray([0, 1, 2, 2])
    cond = np.asarray([2, 1, 0, 4])
    length = np.asarray([VIDEOS[v]["t"] for v in video])
    masks = []
    for v, c in zip(video, cond):
        spec = VIDEOS[v]
        m = spec["prompts"][0][1]
        h = spec["hw"][0]
        # shift the box with the video's moving square
        masks.append(np.roll(m, (0, 3 * c), axis=(0, 1))[:h])
    return video, cond, length, masks


def test_run_round_matches_jax(predictors):
    jpred, tpred = predictors
    video, cond, length, masks = round_plan()
    outs = {}
    for name, pred, mod, pe in (("jax", jpred, jpacked, jpacked_engine),
                                ("torch", tpred, tpacked, tpacked_engine)):
        states = [pred.init_state(make_video(s["t"], s["hw"], s["seed"]))
                  for s in VIDEOS]
        pack = mod.PackedFeatures.build(states)
        cm = np.stack([pe._resize_prompt(m, S) for m in masks])
        outs[name] = mod.PackedPropagator(pred).run_round(
            pack, mod.SlotPlan(video=video, cond=cond, length=length), cm)
    jo, to = outs["jax"], outs["torch"]
    assert sorted(jo["masks"]) == sorted(to["masks"]) == [0, 1, 2, 3]
    for s in range(4):
        t = int(length[s])
        assert sorted(to["masks"][s]) == sorted(to["tokens"][s]) == \
            list(range(t))
        assert_close_masks(np.stack([jo["masks"][s][f] for f in range(t)]),
                           np.stack([to["masks"][s][f] for f in range(t)]),
                           PIX_FRAC)
        for f in range(t):
            np.testing.assert_allclose(to["tokens"][s][f],
                                       jo["tokens"][s][f], atol=TOK_ATOL,
                                       rtol=0)
        small = to["smalls"][s].numpy()
        assert small.shape == np.asarray(jo["smalls"][s]).shape
        assert_close_masks(np.asarray(jo["smalls"][s]), small, PIX_FRAC)


def run_packed(pred, mod):
    jobs, collected, prompt_lists = [], [dict() for _ in VIDEOS], []
    engine = tengine if mod is tpacked_engine else jengine
    for i, spec in enumerate(VIDEOS):
        state = pred.init_state(make_video(spec["t"], spec["hw"],
                                           spec["seed"]))
        prompts = [engine.PromptMask(prompt_id=p.prompt_id,
                                     frame_idx=p.frame_idx,
                                     segmentation=p.segmentation)
                   for p in build_prompts(spec)]
        prompt_lists.append(prompts)
        jobs.append(mod.VideoJob(
            video_id=f"v{i}", state=state, prompts=prompts,
            n_frames=spec["t"], batch_size=4, miou_thresh=0.7,
            n_max_tracks=16,
            on_track=lambda r, d=collected[i]: d.__setitem__(
                r.prompt_id, r)))
    censuses = mod.generate_tracks_packed(pred, jobs)
    return list(zip(censuses, collected, prompt_lists))


def run_sequential(pred):
    out = []
    for spec in VIDEOS:
        state = pred.init_state(make_video(spec["t"], spec["hw"],
                                           spec["seed"]))
        prompts = [tengine.PromptMask(prompt_id=p.prompt_id,
                                      frame_idx=p.frame_idx,
                                      segmentation=p.segmentation)
                   for p in build_prompts(spec)]
        results = {}
        census = tengine.generate_tracks(
            pred, state, prompts, n_frames=spec["t"], batch_size=4,
            miou_thresh=0.7, n_max_tracks=16,
            on_track=lambda r, d=results: d.__setitem__(r.prompt_id, r))
        out.append((census, results, prompts))
    return out


CENSUS_KEYS = ("n_frames", "n_tracked", "n_filtered", "n_not_used",
               "n_total", "tracked_prompt_ids", "filtered_prompt_ids",
               "not_used_prompt_ids", "not_tracked_prompt_ids")


def assert_same_runs(ref, got, frac, small_frac=None):
    for vi, ((cr, rr, pr), (cg, rg, pg)) in enumerate(zip(ref, got)):
        for k in CENSUS_KEYS:
            assert cr[k] == cg[k], (vi, k, cr[k], cg[k])
        for a, b in zip(pr, pg):
            assert (a.status, a.filtered_by) == (b.status, b.filtered_by), \
                (vi, a.prompt_id)
        assert sorted(rr) == sorted(rg)
        for pid in rr:
            a, b = rr[pid], rg[pid]
            assert a.masklet.shape == b.masklet.shape
            assert (a.masklet != b.masklet).mean() < frac, (vi, pid)
            if small_frac is not None:
                assert_close_masks(np.asarray(a.masklet_small),
                                   torch.as_tensor(b.masklet_small).numpy(),
                                   small_frac)
            np.testing.assert_allclose(b.tokens, a.tokens, atol=TOK_ATOL,
                                       rtol=0)


def test_generate_tracks_packed_matches_jax(predictors):
    jpred, tpred = predictors
    ref = run_packed(jpred, jpacked_engine)
    got = run_packed(tpred, tpacked_engine)
    assert sum(c["n_tracked"] for c, _, _ in got) >= 6
    assert_same_runs(ref, got, PIX_FRAC, small_frac=PIX_FRAC)
    # the census counts each video's prompts whatever its pack neighbours
    for (c, _, _), spec in zip(got, VIDEOS):
        assert c["n_total"] == len(spec["prompts"])


def test_packed_matches_sequential(predictors):
    _, tpred = predictors
    assert_same_runs(run_sequential(tpred), run_packed(tpred,
                                                       tpacked_engine),
                     PACK_FRAC)


def test_ungated_push_breaks_agreement(predictors, monkeypatch):
    """A bank push on a slot's idle steps (the gate taken away) must break
    packed-against-sequential agreement on the slots shorter than their
    neighbours, so the gate is what the agreement above rests on."""
    _, tpred = predictors
    video, cond, length, masks = round_plan()
    states = [tpred.init_state(make_video(s["t"], s["hw"], s["seed"]))
              for s in VIDEOS]
    cm = np.stack([tpacked_engine._resize_prompt(m, S) for m in masks])
    prop = tpacked.PackedPropagator(tpred)
    pack = tpacked.PackedFeatures.build(states)
    plan = tpacked.SlotPlan(video=video, cond=cond, length=length)
    good = prop.run_round(pack, plan, cm)
    monkeypatch.setattr(tpacked, "gate", lambda active: np.ones_like(active))
    bad = prop.run_round(pack, plan, cm)
    # slots 0, 1 and 3 run idle forward steps beside the 9-frame video's
    # cond-0 slot, then a reverse pass that reads the pushed memories
    drift = max(np.abs(bad["tokens"][s][f] - good["tokens"][s][f]).max()
                for s in (0, 1, 3) for f in range(int(length[s])))
    assert drift > TOK_ATOL, drift
    # slot 2 (cond 0) has no idle forward step and no reverse pass
    for f in range(9):
        np.testing.assert_array_equal(bad["tokens"][2][f],
                                      good["tokens"][2][f])


def test_run_round_collect_false_banks(predictors):
    """A round leaves its final banks in ``prop.steps.banks``, and the
    same round run again leaves the same banks."""
    _, tpred = predictors
    t, hw = 5, (48, 64)
    state = tpred.init_state(make_video(t, hw, seed=9))
    prop = tpacked.PackedPropagator(tpred)
    pack = tpacked.PackedFeatures.build([state])
    cm = np.zeros((4, S, S), np.float32)
    cm[0] = tpacked_engine._resize_prompt(box_mask(hw, 6, 20, 4, 14), S)
    plan = tpacked.SlotPlan(video=np.asarray([0, -1, -1, -1]),
                            cond=np.zeros(4, np.int64),
                            length=np.asarray([t, 1, 1, 1]))
    full = prop.run_round(pack, plan, cm)
    assert sorted(full["masks"]) == [0] and len(full["masks"][0]) == t
    first = prop.steps.banks
    ring, ptrs = first.recent_mem.clone(), first.obj_ptrs.clone()
    assert torch.isfinite(ring).all() and bool(first.recent_valid[0].any())
    prop.run_round(pack, plan, cm)
    assert torch.equal(ring, prop.steps.banks.recent_mem)
    assert torch.equal(ptrs, prop.steps.banks.obj_ptrs)


def _grid_workspace(root):
    """tests/test_packed.py's CLI workspace: 3 videos of 4, 6 and 8 JPEG
    frames at 40x56 with 1-3 prompts on frame 0, prompt JSONs for the
    sequential, packed and JAX output roots."""
    from PIL import Image
    data_dir = root / "datasets" / "mevis" / "valid_u"
    prompt_dirs = []
    for out_root in ("seq", "packed", "jax"):
        d = (root / out_root / "sam2_prompts" / "grid_prompts" / "mevis"
             / "valid_u")
        d.mkdir(parents=True)
        prompt_dirs.append(d)
    meta = {"videos": {}}
    rng = np.random.default_rng(3)
    for v in range(3):
        vid = f"vid{v}"
        frames_dir = data_dir / "JPEGImages" / vid
        frames_dir.mkdir(parents=True)
        t_v = 4 + 2 * v
        for t in range(t_v):
            img = rng.integers(0, 50, (40, 56, 3), dtype=np.uint8)
            img[8:20, 4 + 4 * t:16 + 4 * t] = 210
            Image.fromarray(img).save(frames_dir / f"{t:05d}.jpg")
        meta["videos"][vid] = {
            "frames": [f"{t:05d}" for t in range(t_v)],
            "expressions": {"0": {"exp": "thing", "anno_id": [v]}}}
        prompts = []
        for i in range(v + 1):
            m = np.zeros((40, 56), np.uint8)
            m[8 + 10 * i:20 + 10 * i, 4:20] = 1
            prompts.append({"prompt_id": i, "frame_idx": 0,
                            "segmentation": jrle.encode(m)})
        for prompt_dir in prompt_dirs:
            (prompt_dir / f"{vid}.json").write_text(json.dumps(
                {"video_id": vid, "bin_size": 4, "prompt_masks": prompts}))
    (data_dir / "meta_expressions.json").write_text(json.dumps(meta))
    return sorted(meta["videos"])


def _grid_tracks(tracks_mod, rle_mod, out_root, vid):
    recs = tracks_mod.load_track_records(
        os.path.join(out_root, "sam2_tracks"), "grid_tracks", "mevis",
        "valid_u", vid, use_index=False)
    out = {}
    for rec in recs:
        with open(rec.masklet_path) as fh:
            out[rec.sam2_anno_id] = (rle_mod.decode_masklet(
                json.load(fh)["rle"]), np.load(rec.token_path))
    return out


def test_tokens_grid_cli_video_pack(tmp_path, predictors):
    """tokens_grid.main --video_pack 3 against the port's sequential run
    and against the JAX CLI with --video_pack 3."""
    jpred, tpred = predictors
    vids = _grid_workspace(tmp_path)
    infos = {}
    for name, mod, pred, extra in (
            ("seq", ttokens_grid, tpred, ["--device", "cpu"]),
            ("packed", ttokens_grid, tpred,
             ["--device", "cpu", "--video_pack", "3"]),
            ("jax", jtokens_grid, jpred, ["--video_pack", "3"])):
        out_root = str(tmp_path / name)
        mod.main(["--dataset", "mevis", "--data_type", "valid_u",
                  "--bin_size", "4", "--data_root", str(tmp_path),
                  "--output_root", out_root, "--n_max_tracks", "8"] + extra,
                 predictor_factory=lambda p=pred: p)
        with open(os.path.join(out_root, "sam2_tracks/grid_tracks/mevis/"
                               "valid_u/runtime_info_4.json")) as fh:
            infos[name] = json.load(fh)
    assert sorted(infos["seq"]) == sorted(infos["packed"]) == \
        sorted(infos["jax"]) == vids
    for vid in vids:
        for k in ("n_tracked", "n_filtered", "n_not_used", "n_total",
                  "tracked_prompt_ids", "filtered_prompt_ids"):
            assert infos["seq"][vid][k] == infos["packed"][vid][k] == \
                infos["jax"][vid][k], (vid, k)
        seq = _grid_tracks(ttracks, trle, str(tmp_path / "seq"), vid)
        pk = _grid_tracks(ttracks, trle, str(tmp_path / "packed"), vid)
        jx = _grid_tracks(jtracks, jrle, str(tmp_path / "jax"), vid)
        assert sorted(seq) == sorted(pk) == sorted(jx) and seq
        for pid in seq:
            assert (seq[pid][0] != pk[pid][0]).mean() < PACK_FRAC
            np.testing.assert_allclose(pk[pid][1], seq[pid][1],
                                       atol=TOK_ATOL, rtol=0)
            assert_close_masks(jx[pid][0], pk[pid][0], PIX_FRAC)
            np.testing.assert_allclose(pk[pid][1], jx[pid][1],
                                       atol=TOK_ATOL, rtol=0)


def test_run_expressions_packed_matches_jax(tmp_path, predictors):
    """Expression packing on one shared state in both packages, and the
    port's packed run against its pack width 1 (``run_video_packed`` at
    ``expr_pack`` 1, the CLI's default: one expression a group)."""
    jpred, tpred = predictors
    t, hw = 5, (48, 64)
    frames = make_video(t, hw, seed=5)
    prompts, pid = [], 0
    for expr_id, x in (("0", 4), ("1", 24), ("2", 40)):
        for fi in (0, 1):
            m = np.zeros(hw, np.uint8)
            m[6 + 6 * fi:20 + 6 * fi, x:x + 14] = 1
            prompts.append({
                "segmentation": jrle.encode(m), "stability_score": 0.95,
                "area": int(m.sum()), "area_ratio": 0.05,
                "frame_idx": fi, "expression_id": expr_id,
                "prompt_id": pid})
            pid += 1
    prompt_path = str(tmp_path / "vid0.json")
    with open(prompt_path, "w") as fh:
        json.dump({"video_id": "vid0", "bin_size": 1,
                   "prompt_masks": prompts}, fh)
    exprs = ["0", "1", "2"]
    kw = dict(bin_size=1, n_max_tracks=8, log=lambda s: None)
    censuses, roots = {}, {}
    for name, mod, pred in (("jax", jtokens_gdino, jpred),
                            ("torch", ttokens_gdino, tpred)):
        roots[name] = str(tmp_path / name / "sam2_tracks")
        censuses[name] = mod.run_expressions_packed(
            pred, pred.init_state(frames), "vid0", exprs, prompt_path,
            roots[name], "mevis", "valid_u", t, **kw)
    seq_root = str(tmp_path / "seq" / "sam2_tracks")
    state = tpred.init_state(frames)
    seq = ttokens_gdino.run_video_packed(
        tpred, state, "vid0", exprs, prompt_path, seq_root, "mevis",
        "valid_u", t, expr_pack=1, **kw)
    for e in exprs:
        for k in ("n_total", "n_not_used", "n_tracked", "n_filtered",
                  "tracked_prompt_ids", "filtered_prompt_ids"):
            assert censuses["torch"][e][k] == censuses["jax"][e][k] == \
                seq[e][k], (e, k)
        recs = {}
        for name, tr, rl, root in (
                ("jax", jtracks, jrle, roots["jax"]),
                ("torch", ttracks, trle, roots["torch"]),
                ("seq", ttracks, trle, seq_root)):
            out = {}
            for rec in tr.load_track_records(root, "gdino_tracks", "mevis",
                                             "valid_u", "vid0",
                                             expression_id=e,
                                             use_index=False):
                with open(rec.masklet_path) as fh:
                    out[rec.sam2_anno_id] = (rl.decode_masklet(
                        json.load(fh)["rle"]), np.load(rec.token_path))
            recs[name] = out
        assert sorted(recs["jax"]) == sorted(recs["torch"]) == \
            sorted(recs["seq"]) and recs["torch"]
        for p in recs["torch"]:
            tm, tt = recs["torch"][p]
            assert_close_masks(recs["jax"][p][0], tm, PIX_FRAC)
            np.testing.assert_allclose(tt, recs["jax"][p][1], atol=TOK_ATOL,
                                       rtol=0)
            assert (recs["seq"][p][0] != tm).mean() < PACK_FRAC
            np.testing.assert_allclose(tt, recs["seq"][p][1], atol=TOK_ATOL,
                                       rtol=0)
