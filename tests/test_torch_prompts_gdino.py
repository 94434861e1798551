"""The GroundingDINO slice end to end in both packages at tiny size, fp32 on
the CPU, with shared weights: SAM2ImagePredictor.predict_packed, the
pipelined generate_video_prompts, tokens_gdino's expressions one a group
(the CLI's default) on the prompt JSON, and both CLIs over a MeViS-layout workspace. Scores and stability
agree within 1e-4, boxes within 1e-3 px, masks within 0.5% of their pixels
(a logit at the 0 threshold may round either way), censuses exactly."""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sola_tpu.core import rle as jrle
from sola_tpu.data import tracks as jtracks
from sola_tpu.trackgen import prompts_gdino as jprompts
from sola_tpu.trackgen import tokens_gdino as jtokens
from sola_tpu.trackgen.gdino import model as jgd
from sola_tpu.trackgen.sam2.image import SAM2ImagePredictor as JImage
from sola_tpu.trackgen.sam2.model import SAM2Config as JSAM2Config
from sola_tpu.trackgen.sam2.model import SAM2Model as JSAM2Model
from sola_tpu.trackgen.sam2.video import SAM2VideoPredictor as JVideo
from sola_torch.core import rle as trle
from sola_torch.data import tracks as ttracks
from sola_torch.trackgen import prompts_gdino as tprompts
from sola_torch.trackgen import tokens_gdino as ttokens
from sola_torch.trackgen.gdino import model as tgd
from sola_torch.trackgen.sam2 import image as timage
from sola_torch.trackgen.sam2.convert import state_dict_from_jax_params
from sola_torch.trackgen.sam2.model import SAM2Config, SAM2Model
from sola_torch.trackgen.sam2.video import SAM2VideoPredictor
from test_torch_gdino import jax_gdino, port_gdino

# frames upscale on both axes to the SAM2 model size, as MeViS's 480x854
# frames do to 1024: the encode's uint8 round trip then matches bit for bit
T, H, W = 6, 48, 64
VID = "vid0"
EXPRESSIONS = {"0": {"exp": "the red car", "anno_id": [0]},
               "1": {"exp": "a walking dog", "anno_id": [1]}}
PIX_FRAC = 5e-3
# random weights give stability scores of about 0.25 to 0.45: this gate
# passes some prompts to tracking and holds others back
STAB_THRESH = 0.35


def make_frames(seed=0):
    rng = np.random.default_rng(seed)
    frames = []
    for t in range(T):
        f = (rng.random((H, W, 3)) * 40).astype(np.uint8)
        f[8:24, 6 + 3 * t:22 + 3 * t] = (220, 80, 40)
        f[28:44, 50 - 3 * t:64 - 3 * t] = (40, 200, 90)
        frames.append(f)
    return frames


@pytest.fixture(scope="module")
def stack():
    """(jax, port) pairs of the grounding model, the image predictor and
    the video predictor, each pair on the same weights."""
    torch.set_num_threads(2)
    jg, gvars = jax_gdino(jgd.GDINOConfig.tiny_test())
    tg = port_gdino(gvars, tgd.GDINOConfig.tiny_test())
    jcfg = JSAM2Config.tiny_test(image_size=64)
    jsam = JSAM2Model(jcfg)
    svars = jax.jit(jsam.init)(jax.random.PRNGKey(1),
                               jnp.zeros((1, 64, 64, 3), jnp.float32))
    svars = jax.tree_util.tree_map(np.asarray, svars)
    cfg = SAM2Config.tiny_test(image_size=64)

    def port_sam2():
        m = SAM2Model(cfg)
        m.load_state_dict(state_dict_from_jax_params(svars, cfg),
                          strict=True)
        return m

    return {
        "grounding": (jgd.GroundingModel(jg, gvars),
                      tgd.GroundingModel(tg)),
        "image": (JImage(jsam, svars, compute_dtype=jnp.float32),
                  timage.SAM2ImagePredictor(port_sam2(),
                                            compute_dtype=torch.float32)),
        "video": (JVideo(jsam, svars, obj_batch=2, feature_dtype=jnp.float32,
                         compute_dtype=jnp.float32),
                  SAM2VideoPredictor(port_sam2(), obj_batch=2,
                                     feature_dtype=torch.float32,
                                     compute_dtype=torch.float32)),
    }


def _threshold(stack, frames):
    """A box threshold that keeps about a third of the queries."""
    jgm = stack["grounding"][0]
    preds = jgm.get_boxes_many(frames[0], [e["exp"] for e in
                                           EXPRESSIONS.values()], -1.0)
    scores = [max(p["token_score"]) for ps in preds for p in ps]
    return float(np.quantile(scores, 2 / 3))


def _assert_masks_close(a, b):
    assert a.shape == b.shape
    assert (a != b).mean() <= PIX_FRAC, (a != b).mean()


def test_predict_packed_matches_jax(stack):
    jpred, tpred = stack["image"]
    frame = make_frames()[0]
    boxes = np.array([[4, 6, 30, 28], [40, 20, 62, 46], [0, 0, 64, 48],
                      [10.5, 3.25, 20.75, 40.5], [50, 1, 60, 9]], np.float32)
    for pred in (jpred, tpred):
        pred.set_image(frame)
    jm, js, jst = jpred.predict_packed(box=boxes)
    tm, ts, tst = tpred.predict_packed(box=boxes)
    assert tm.shape == (5, H, W) and tm.dtype == bool
    _assert_masks_close(tm, jm)
    np.testing.assert_allclose(ts, js, atol=1e-4, rtol=0)
    np.testing.assert_allclose(tst, jst, atol=1e-4, rtol=0)
    # the dense predict gives the same masks, scores and stability
    dm, dscore, dlow = tpred.predict(box=boxes, multimask_output=False)
    np.testing.assert_array_equal(dm[:, 0], tm)
    np.testing.assert_allclose(dscore[:, 0], ts, atol=1e-6)
    np.testing.assert_allclose(timage.compute_stability_score(dlow[:, 0]),
                               tst, atol=1e-6)
    jdm, jdscore, jdlow = jpred.predict(box=boxes, multimask_output=True)
    tdm, tdscore, tdlow = tpred.predict(box=boxes, multimask_output=True)
    _assert_masks_close(tdm, jdm)
    np.testing.assert_allclose(tdscore, jdscore, atol=1e-4, rtol=0)
    np.testing.assert_allclose(tdlow, jdlow, atol=1e-3, rtol=0)


def test_predict_packed_bf16_matches_jax(stack):
    """The CLI's bf16 image predictor (bf16-rounded weights, bf16 patch
    embedding, fp32 after it) against the JAX package's bf16 predictor on
    the same weights, within the fp32 test's limits."""
    jpred32 = stack["image"][0]
    jpred = JImage(jpred32.model, jpred32.variables,
                   compute_dtype=jnp.bfloat16)
    cfg = SAM2Config.tiny_test(image_size=64)
    model = SAM2Model(cfg)
    model.load_state_dict(state_dict_from_jax_params(jpred32.variables, cfg),
                          strict=True)
    tpred = timage.SAM2ImagePredictor(model, compute_dtype=torch.bfloat16)
    frame = make_frames()[3]
    boxes = np.array([[4, 6, 30, 28], [0, 0, 64, 48], [30, 20, 50, 46]],
                     np.float32)
    for pred in (jpred, tpred):
        pred.set_image(frame)
    jm, js, jst = jpred.predict_packed(box=boxes)
    tm, ts, tst = tpred.predict_packed(box=boxes)
    _assert_masks_close(tm, jm)
    np.testing.assert_allclose(ts, js, atol=1e-4, rtol=0)
    np.testing.assert_allclose(tst, jst, atol=1e-4, rtol=0)


def test_bitpack_round_trip():
    m = np.random.default_rng(0).random((3, 5, 13)) > 0.5
    packed = timage._bitpack_masks(torch.from_numpy(m)).numpy()
    assert packed.shape == (3, 5, 2) and packed.dtype == np.uint8
    np.testing.assert_array_equal(np.packbits(np.pad(
        m, ((0, 0), (0, 0), (0, 3))), axis=-1), packed)
    np.testing.assert_array_equal(timage.unpack_masks(packed, 5, 13), m)


def _match_prompts(tinfo, jinfo):
    """Pairs of (port, jax) prompt entries: the same (frame, expression)
    and the nearest box."""
    pt, pj = tinfo["prompt_masks"], jinfo["prompt_masks"]
    assert len(pt) == len(pj) > 0
    pairs, used = [], set()
    for a in pj:
        cands = [(np.abs(np.subtract(b["pred_bbox"], a["pred_bbox"])).max(),
                  i) for i, b in enumerate(pt)
                 if i not in used and b["frame_idx"] == a["frame_idx"]
                 and b["expression_id"] == a["expression_id"]]
        dist, i = min(cands)
        assert dist <= 1e-3, dist
        used.add(i)
        pairs.append((pt[i], a))
    return pairs


def _assert_same_prompt_json(tinfo, jinfo):
    assert tinfo["video_id"] == jinfo["video_id"]
    assert tinfo["bin_size"] == jinfo["bin_size"]
    for a, b in _match_prompts(tinfo, jinfo):
        assert set(a) == set(b)
        assert a["pred_phrase"] == b["pred_phrase"]
        np.testing.assert_allclose(a["token_score"], b["token_score"],
                                   atol=1e-4, rtol=0)
        np.testing.assert_allclose(a["score"], b["score"], atol=1e-4,
                                   rtol=0)
        np.testing.assert_allclose(a["stability_score"],
                                   b["stability_score"], atol=1e-4, rtol=0)
        _assert_masks_close(trle.decode(a["segmentation"]),
                            jrle.decode(b["segmentation"]))
        assert abs(a["area"] - b["area"]) <= PIX_FRAC * H * W
        assert a["metrics"].keys() == b["metrics"].keys()
        for k in a["metrics"]:
            assert abs(a["metrics"][k]["iou"] - b["metrics"][k]["iou"]) \
                <= 0.05


def _gt(frames):
    """Per-anno GT masklets: the red box (anno 0) and the green box
    (anno 1), frame 4 missing for anno 1."""
    red = [(f == (220, 80, 40)).all(-1).astype(np.uint8) for f in frames]
    green = [(f == (40, 200, 90)).all(-1).astype(np.uint8) for f in frames]
    green[4] = None
    return {"0": red, "1": green}, {e: m["anno_id"] for e, m in
                                    EXPRESSIONS.items()}


@pytest.fixture(scope="module")
def prompt_infos(stack):
    """generate_video_prompts through the pipelined PromptGenerator in both
    packages on the same frames."""
    frames = make_frames()
    thr = _threshold(stack, frames)
    gt, anno = _gt(frames)
    infos = {}
    for name, mod, i in (("jax", jprompts, 0), ("torch", tprompts, 1)):
        pg = mod.PromptGenerator(stack["grounding"][i], stack["image"][i],
                                 box_threshold=thr)
        infos[name] = mod.generate_video_prompts(
            pg, frames, VID, EXPRESSIONS, bin_size=4, gt_masklets=gt,
            anno_ids_by_expr=anno)
    return frames, infos


def test_generate_video_prompts_matches_jax(prompt_infos):
    _, infos = prompt_infos
    _assert_same_prompt_json(infos["torch"], infos["jax"])
    frames = {p["frame_idx"] for p in infos["torch"]["prompt_masks"]}
    assert frames == {0, 4}
    areas = [p["area"] for p in infos["torch"]["prompt_masks"]]
    assert areas == sorted(areas, reverse=True)
    assert [p["prompt_id"] for p in infos["torch"]["prompt_masks"]] == \
        list(range(len(areas)))


def test_pipelined_matches_sequential(stack):
    """The one-frame look-ahead (enqueue/harvest interleave, feature
    snapshot/restore, predict_packed) gives the sequential JSON: the same
    prompts in the same order with the same masks; boxes within 1e-3 px and
    scores within 1e-4, since the expression-batched forward sums in
    another order than the one-text forward."""
    frames = make_frames(1)
    gm = stack["grounding"][1]

    class Sequential:  # no enqueue_boxes: the pipeline is off
        def get_boxes(self, *a, **k):
            return gm.get_boxes(*a, **k)

    thr = _threshold(stack, frames)
    out = {}
    for name, g in (("pipe", gm), ("seq", Sequential())):
        pg = tprompts.PromptGenerator(g, stack["image"][1], box_threshold=thr)
        out[name] = tprompts.generate_video_prompts(pg, frames, VID,
                                                    EXPRESSIONS, bin_size=2)
    pa, pb = out["pipe"].pop("prompt_masks"), out["seq"].pop("prompt_masks")
    assert out["pipe"] == out["seq"]
    assert len(pa) == len(pb) > 0
    for a, b in zip(pa, pb):
        assert set(a) == set(b)
        for k in ("frame_idx", "expression_id", "prompt_id", "pred_phrase",
                  "segmentation", "area", "area_ratio"):
            assert a[k] == b[k], k
        np.testing.assert_allclose(a["pred_bbox"], b["pred_bbox"], atol=1e-3,
                                   rtol=0)
        for k in ("token_score", "score", "stability_score"):
            np.testing.assert_allclose(a[k], b[k], atol=1e-4, rtol=0)


def _strip(census):
    return {k: v for k, v in census.items() if k not in ("time", "fps")}


def _tracks(tracks_mod, rle_mod, root, expression_id):
    recs = tracks_mod.load_track_records(root, "gdino_tracks", "mevis",
                                         "valid_u", VID,
                                         expression_id=expression_id,
                                         use_index=False)
    out = {}
    for rec in recs:
        with open(rec.masklet_path) as fh:
            info = json.load(fh)
        out[rec.sam2_anno_id] = (rle_mod.decode_masklet(info["rle"]),
                                 np.load(rec.token_path))
    return out


def _assert_same_tracks(tt, jt):
    assert sorted(tt) == sorted(jt)
    for pid in jt:
        (jm, jtok), (tm, ttok) = jt[pid], tt[pid]
        assert tm.shape == jm.shape == (T, H, W)
        assert np.isfinite(ttok).all() and ttok.shape == jtok.shape
        assert (jm != tm).reshape(T, -1).mean(axis=1).max() <= PIX_FRAC
        np.testing.assert_allclose(ttok, jtok, atol=1e-4, rtol=0)


def test_run_expression_matches_jax(stack, prompt_infos, tmp_path):
    """One expression on the JAX package's prompt JSON, through the
    port's default route (``run_video_packed`` at ``expr_pack`` 1) and
    sola_tpu's run_expression: census equal, masklets and tokens within
    tolerance."""
    frames, infos = prompt_infos
    path = str(tmp_path / f"{VID}.json")
    with open(path, "w") as f:
        json.dump(infos["jax"], f)
    for expression_id in EXPRESSIONS:
        res = {}
        kw = dict(bin_size=4, batch_size=2,
                  stability_score_thresh=STAB_THRESH, n_max_tracks=3,
                  log=lambda s: None)
        for name in ("jax", "torch"):
            pred, root = stack["video"][name == "torch"], str(tmp_path / name)
            state = pred.init_state(frames)
            if name == "jax":
                census = jtokens.run_expression(
                    pred, state, VID, expression_id, path, root, "mevis",
                    "valid_u", T, **kw)
            else:
                census = ttokens.run_video_packed(
                    pred, state, VID, [expression_id], path, root, "mevis",
                    "valid_u", T, expr_pack=1, **kw)[expression_id]
            res[name] = (census, root)
        (tc, troot), (jc, jroot) = res["torch"], res["jax"]
        assert _strip(tc) == _strip(jc)
        assert tc["n_tracked"] >= 1
        _assert_same_tracks(_tracks(ttracks, trle, troot, expression_id),
                            _tracks(jtracks, jrle, jroot, expression_id))


def test_load_expression_prompts_matches_jax(tmp_path):
    """Gated prompts (off-bin frame, low stability) are counted but not
    listed, the reference's quirk."""
    m = np.zeros((8, 8), np.uint8)
    m[2:5, 3:6] = 1
    prompts = [{"segmentation": jrle.encode(m), "frame_idx": f,
                "stability_score": s, "expression_id": e, "prompt_id": i}
               for i, (f, s, e) in enumerate([(0, 0.9, "0"), (1, 0.95, "0"),
                                              (4, 0.5, "0"), (4, 0.99, "1"),
                                              (8, 0.86, "0")])]
    path = str(tmp_path / "p.json")
    with open(path, "w") as f:
        json.dump({"video_id": VID, "bin_size": 4, "prompt_masks": prompts},
                  f)
    for e in ("0", "1"):
        tp, tn, tt = ttokens.load_expression_prompts(path, VID, 4, e)
        jp, jn, jt = jtokens.load_expression_prompts(path, VID, 4, e)
        assert (tn, tt) == (jn, jt)
        assert [(p.prompt_id, p.frame_idx) for p in tp] == \
            [(p.prompt_id, p.frame_idx) for p in jp]
    assert tprompts.normalize_expression("  A Dog ") == "a dog."


def _workspace(tmp_path, frames):
    from PIL import Image
    data_dir = tmp_path / "datasets" / "mevis" / "valid"
    frames_dir = data_dir / "JPEGImages" / VID
    frames_dir.mkdir(parents=True)
    for t, f in enumerate(frames):
        Image.fromarray(f).save(frames_dir / f"{t:05d}.png")
    meta = {"videos": {VID: {"frames": [f"{t:05d}" for t in range(T)],
                             "expressions": EXPRESSIONS}}}
    (data_dir / "meta_expressions.json").write_text(json.dumps(meta))


def test_main_clis_match_jax(stack, tmp_path):
    """prompts_gdino.main then tokens_gdino.main over a MeViS-layout
    workspace (lossless PNG frames), factories injected, in both packages:
    equal prompt JSONs and censuses; a second tokens run resumes with
    nothing left to do."""
    frames = make_frames(2)
    _workspace(tmp_path, frames)
    thr = _threshold(stack, frames)
    out = {}
    for name, pmod, tmod, i in (("jax", jprompts, jtokens, 0),
                                ("torch", tprompts, ttokens, 1)):
        root = tmp_path / name
        argv = ["--data_root", str(tmp_path), "--output_root", str(root),
                "--data_type", "valid"]
        if name == "torch":
            argv += ["--device", "cpu"]
        pmod.main(argv + ["--box_threshold", str(thr)],
                  generator_factory=lambda i=i: pmod.PromptGenerator(
                      stack["grounding"][i], stack["image"][i],
                      box_threshold=thr))
        targv = argv + ["--batch_size", "2", "--n_max_tracks", "2",
                        "--stability_score_thresh", str(STAB_THRESH)]
        tmod.main(targv, predictor_factory=lambda i=i: stack["video"][i])
        prompt = root / "sam2_prompts" / "gdino_prompts" / "mevis" / "valid"
        runtime = root / "sam2_tracks" / "gdino_tracks" / "mevis" / "valid" \
            / "runtime_info.json"
        with open(prompt / f"{VID}.json") as f:
            info = json.load(f)
        with open(runtime) as f:
            census = json.load(f)
        before = os.path.getmtime(runtime)
        tmod.main(targv, predictor_factory=lambda i=i: stack["video"][i])
        assert os.path.getmtime(runtime) == before
        out[name] = (info, census)
    _assert_same_prompt_json(out["torch"][0], out["jax"][0])
    tc, jc = out["torch"][1][VID], out["jax"][1][VID]
    assert sorted(tc) == sorted(jc) == sorted(EXPRESSIONS)
    for e in EXPRESSIONS:
        assert _strip(tc[e]) == _strip(jc[e])

