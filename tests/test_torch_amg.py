"""The grid-prompt slice in both packages at tiny size, fp32 on the CPU,
with shared weights (state_dict_from_jax_params): SAM2ImagePredictor's
propose / propose_filter / finalize_masks_packed, the automatic mask
generator (single pass, the overflow fallback, the small-region
postprocess through core/ccl.py, the pipelined generate_many), and
prompts_grid's generate_video_prompts and CLI.

Every predictor test runs on 48x64 frames and on 48x72 frames. A 48x64
frame upscales on both axes to SAM2's 64, as MeViS's 480x854 frames do to
1024, and the port's encode matches JAX's bit for bit. A 48x72 frame
downscales in width, as Ref-YTVOS's 720x1280 frames do. There the two
packages' antialiased resizes differ in their last bits (XLA's CPU code
for jax.image.resize rounds its weights and sums in an order that changes
with the shape), and the uint8 truncation after it turns that into a gray
level on some pixels. So at 48x72 the port's predictor takes its uint8
model-size frame from jax.image.resize (``_ReferenceResize``), and
everything after the resize is held as tightly as at 48x64: the point
scaling, the decoders, the survivor buffer, the finalize at 48x72, the
records. The resize's own drift is bounded by the last test and measured
by scripts/torch_resize_drift.py.

The AMG thresholds sit at the midpoint of the widest gap in JAX's own
scores, so no score lies within 1e-3 of one. Scores agree within 1e-5,
survivors and records in the same order, and a decoded mask may differ in
at most PIX_FRAC of its pixels (a logit at 0 may round either way)."""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sola_tpu.core import ccl as jccl
from sola_tpu.core import rle as jrle
from sola_tpu.trackgen import prompts_grid as jprompts
from sola_tpu.trackgen.sam2 import amg as jamg
from sola_tpu.trackgen.sam2.image import SAM2ImagePredictor as JImage
from sola_tpu.trackgen.sam2.model import SAM2Config as JConfig
from sola_tpu.trackgen.sam2.model import SAM2Model as JModel
from sola_torch.core import ccl as tccl
from sola_torch.core import rle as trle
from sola_torch.trackgen import prompts_grid as tprompts
from sola_torch.trackgen.sam2 import amg as tamg
from sola_torch.trackgen.sam2 import image as timage
from sola_torch.trackgen.sam2.convert import state_dict_from_jax_params
from sola_torch.trackgen.sam2.model import SAM2Config, SAM2Model

S, H = 64, 48
PIX_FRAC = 5e-3
SCORE_ATOL = 1e-5
SIDE, CHUNK = 8, 16          # 64 grid points in 4 chunks of 16


def make_frame(t, w, seed=0):
    rng = np.random.default_rng(seed + t)
    f = (rng.random((H, w, 3)) * 50).astype(np.uint8)
    f[6:26, 4 + 3 * t:30 + 3 * t] = (220, 80, 40)
    f[28:46, w - 26 - 2 * t:w - 4 - 2 * t] = (40, 200, 90)
    f[14:22, 34:42] = (60, 80, 240)
    return f


_jax_resize = jax.jit(lambda raw: jax.image.resize(
    raw.astype(jnp.float32), (S, S, 3), method="linear").astype(jnp.uint8))


class _ReferenceResize(timage.SAM2ImagePredictor):
    """The port's predictor, its frame resized to the model size by
    jax.image.resize as the JAX predictor resizes it; the rest of the
    encode (normalize, Hiera, FPN) is the port's."""

    def set_image(self, image):
        super().set_image(np.asarray(_jax_resize(image)))
        self._orig_hw = tuple(image.shape[:2])


@pytest.fixture(scope="module")
def all_predictors():
    """The JAX image predictor, the port's, and the port's behind the
    reference resize, on the same weights, fp32 compute."""
    torch.set_num_threads(2)
    jmodel = JModel(JConfig.tiny_test(image_size=S))
    variables = jax.jit(jmodel.init)(jax.random.PRNGKey(1),
                                     jnp.zeros((1, S, S, 3), jnp.float32))
    variables = jax.tree_util.tree_map(np.asarray, variables)
    cfg = SAM2Config.tiny_test(image_size=S)
    ports = []
    for cls in (timage.SAM2ImagePredictor, _ReferenceResize):
        model = SAM2Model(cfg)
        model.load_state_dict(state_dict_from_jax_params(variables, cfg),
                              strict=True)
        ports.append(cls(model, compute_dtype=torch.float32))
    return (JImage(jmodel, variables, compute_dtype=jnp.float32), *ports)


@pytest.fixture(scope="module", params=[64, 72], ids=["48x64", "48x72"])
def width(request):
    return request.param


@pytest.fixture(scope="module")
def predictors(all_predictors, width):
    """(jax, port) image predictors for frames ``width`` wide."""
    jpred, port, port_ref_resize = all_predictors
    return jpred, (port if width <= S else port_ref_resize)


def grid_points(w, side=SIDE):
    return jamg.build_point_grid(side) * np.asarray([w, H], np.float32)


def _gap_midpoint(values):
    """Midpoint of the widest gap between neighbouring distinct values in
    the middle 80% of ``values``."""
    v = np.unique(np.asarray(values, np.float64))
    lo, hi = int(0.1 * len(v)), int(0.9 * len(v))
    gaps = np.diff(v[lo:hi + 1])
    i = int(np.argmax(gaps))
    return float(0.5 * (v[lo + i] + v[lo + i + 1]))


@pytest.fixture(scope="module")
def thresholds(predictors, width):
    """(iou, stability) thresholds from JAX's scores over the grid of
    frames 0-3: midpoints of the widest gaps, away from every score."""
    jpred = predictors[0]
    ious, stabs = [], []
    for t in range(4):
        jpred.set_image(make_frame(t, width))
        i, s, _ = jpred.propose(grid_points(width)[:, None])
        ious.append(i.ravel())
        stabs.append(s.ravel())
    ious, stabs = np.concatenate(ious), np.concatenate(stabs)
    iou_t, stab_t = _gap_midpoint(ious), _gap_midpoint(stabs)
    assert np.abs(ious - iou_t).min() > 1e-3
    assert np.abs(stabs - stab_t).min() > 1e-3
    return iou_t, stab_t


def _amg(pred, iou_t, stab_t, **kw):
    cls = (jamg.SAM2AutomaticMaskGenerator if isinstance(pred, JImage)
           else tamg.SAM2AutomaticMaskGenerator)
    kw.setdefault("points_per_side", SIDE)
    kw.setdefault("points_per_batch", CHUNK)
    return cls(pred, pred_iou_thresh=iou_t, stability_score_thresh=stab_t,
               **kw)


def _assert_masks_close(a, b):
    assert a.shape == b.shape
    assert (a != b).mean() <= PIX_FRAC, (a != b).mean()


def _assert_same_records(got, ref, exact_masks=False):
    assert len(got) == len(ref) > 0
    for a, b in zip(got, ref):
        if exact_masks:
            assert (a["area"], a["bbox"]) == (b["area"], b["bbox"])
        else:  # a pixel at the 0 threshold may move a box edge by one
            assert abs(a["area"] - b["area"]) <= PIX_FRAC * a[
                "segmentation"].size
            np.testing.assert_allclose(a["bbox"], b["bbox"], atol=1.0)
        np.testing.assert_allclose(a["predicted_iou"], b["predicted_iou"],
                                   atol=SCORE_ATOL, rtol=0)
        np.testing.assert_allclose(a["stability_score"],
                                   b["stability_score"], atol=SCORE_ATOL,
                                   rtol=0)
        np.testing.assert_allclose(a["point_coords"], b["point_coords"])
        if exact_masks:
            np.testing.assert_array_equal(a["segmentation"],
                                          b["segmentation"])
        else:
            _assert_masks_close(a["segmentation"], b["segmentation"])


def test_propose_matches_jax(predictors, width):
    jpred, tpred = predictors
    for pred in predictors:
        pred.set_image(make_frame(1, width))
    pts = grid_points(width)[:, None]
    ji, js, jl = jpred.propose(pts)
    ti, ts, tl = tpred.propose(pts)
    assert ti.shape == (SIDE * SIDE, 3) and tl.shape == (SIDE * SIDE, 3,
                                                          S // 4, S // 4)
    np.testing.assert_allclose(ti, ji, atol=SCORE_ATOL, rtol=0)
    np.testing.assert_allclose(ts, js, atol=SCORE_ATOL, rtol=0)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4, rtol=0)


def test_finalize_packed_matches_jax(predictors, width):
    """The same low-res logits into both finalizes: masks, boxes and areas
    exactly, an all-negative row giving area 0 and a zero box."""
    jpred, tpred = predictors
    jpred.set_image(make_frame(2, width))
    _, _, low = jpred.propose(grid_points(width, 4)[:, None])
    sel = np.asarray(low)[np.arange(8), np.arange(8) % 3]
    sel = np.concatenate([sel, np.full((1,) + sel.shape[1:], -10.0,
                                       np.float32)])
    jm, jb, ja = jpred.finalize_masks_packed(jnp.asarray(sel), H, width)
    tm, tb, ta = tpred.finalize_masks_packed(torch.from_numpy(sel), H,
                                             width)
    np.testing.assert_array_equal(tm, jm)
    np.testing.assert_array_equal(tb, jb)
    np.testing.assert_array_equal(ta, ja)
    assert ta[-1] == 0 and (tb[-1] == 0).all() and ta[:-1].min() > 0
    np.testing.assert_array_equal(
        tpred.finalize_masks(torch.from_numpy(sel), H, width), jm.astype(
            np.uint8))
    for i in range(len(tm)):
        np.testing.assert_array_equal(tb[i], tamg.box_from_mask(tm[i]))


@pytest.mark.parametrize("points", ["grid", "tied"])
def test_propose_filter_survivors_match_jax(predictors, thresholds, width,
                                            points):
    """The survivor buffer: the same flat indices in the same order. "tied"
    repeats every grid point, so each survivor's score appears twice; equal
    scores must keep their flat order, as jax.lax.top_k keeps them, and a
    buffer too small for all survivors must keep the same leading ones."""
    jpred, tpred = predictors
    iou_t, stab_t = thresholds
    pts = grid_points(width)
    if points == "tied":
        pts = np.repeat(pts, 2, axis=0)
    for pred in predictors:
        pred.set_image(make_frame(0, width))
    outs = []
    for pred in predictors:
        out = pred.propose_filter(pts[:, None], 1.0, iou_t, stab_t,
                                  chunk=CHUNK, k_max=32)
        outs.append([np.asarray(x) if isinstance(x, jax.Array)
                     else x.numpy() for x in out])
    (jsc, jlow, jflat, jiou, jstab, jn), (tsc, tlow, tflat, tiou, tstab,
                                          tn) = outs
    assert int(tn) == int(jn) > 0
    k = min(int(jn), 32)
    np.testing.assert_array_equal(tflat, jflat)
    np.testing.assert_allclose(tsc[:k], jsc[:k], atol=SCORE_ATOL, rtol=0)
    assert np.isneginf(tsc[k:]).all() and (tflat[k:] == -1).all() or k == 32
    np.testing.assert_allclose(tiou, jiou, atol=SCORE_ATOL, rtol=0)
    np.testing.assert_allclose(tstab, jstab, atol=SCORE_ATOL, rtol=0)
    np.testing.assert_allclose(tlow[:k], jlow[:k], atol=1e-4, rtol=0)
    if points == "tied":
        # ties are present among the kept scores, and order decides them
        assert len(np.unique(tsc[:k])) < k
        assert (np.diff(tflat[:k]) > 0)[np.diff(tsc[:k]) == 0].all()


# random weights give masks that cover most of the frame, so NMS at 0.7
# keeps one record; at 1.0 it keeps every survivor (~100), whose order is
# then tested too
@pytest.mark.parametrize("nms_thresh", [0.7, 1.0])
def test_generate_matches_jax(predictors, thresholds, width, nms_thresh):
    jamg_, tamg_ = (_amg(p, *thresholds, box_nms_thresh=nms_thresh)
                    for p in predictors)
    frame = make_frame(3, width)
    ref = jamg_.generate(frame)
    got = tamg_.generate(frame)
    assert len(got) > (50 if nms_thresh == 1.0 else 0)
    _assert_same_records(got, ref)
    assert [r["area"] for r in got] == sorted((r["area"] for r in got),
                                              reverse=True)


def test_overflow_fallback_matches_single_pass(predictors, thresholds,
                                               width):
    """max_survivors 4 overflows, so the per-chunk path runs; it gives the
    single-pass path's records, and JAX's fallback's."""
    frame = make_frame(2, width)
    predictors[1].set_image(frame)
    n_valid = predictors[1].propose_filter(
        grid_points(width)[:, None], 1.0, *thresholds, chunk=CHUNK,
        k_max=4)[-1]
    assert int(n_valid) > 4
    kw = dict(box_nms_thresh=1.0)
    single = _amg(predictors[1], *thresholds, **kw).generate(frame)
    fallback = _amg(predictors[1], *thresholds, max_survivors=4,
                    **kw).generate(frame)
    assert len(single) > 50
    _assert_same_records(fallback, single, exact_masks=True)
    ref = _amg(predictors[0], *thresholds, max_survivors=4,
               **kw).generate(frame)
    _assert_same_records(fallback, ref)


def test_generate_many_equals_generate(predictors, thresholds, width):
    amg = _amg(predictors[1], *thresholds, box_nms_thresh=1.0)
    frames = [make_frame(t, width) for t in range(4)]
    for many, one in zip(amg.generate_many(iter(frames)),
                         [amg.generate(f) for f in frames]):
        assert len(many) == len(one)
        for a, b in zip(many, one):
            assert a["area"] == b["area"] and a["bbox"] == b["bbox"]
            assert a["predicted_iou"] == b["predicted_iou"]
            np.testing.assert_array_equal(a["segmentation"],
                                          b["segmentation"])


def test_ccl_matches_jax():
    """core/ccl.py against the JAX package's on random masks: the same
    component partition and the same small-region edits."""
    rng = np.random.default_rng(4)
    for _ in range(4):
        mask = rng.random((37, 53)) > 0.55
        tl, tn = tccl.label(mask)
        jl, jn = jccl.label(mask)
        assert tn == jn
        np.testing.assert_array_equal(tl, jl)
        for area in (3, 9):
            for mode in ("holes", "islands"):
                tm, tc = tccl.remove_small_regions(mask, area, mode)
                jm, jc = jccl.remove_small_regions(mask, area, mode)
                assert tc == jc
                np.testing.assert_array_equal(tm, jm)


def test_small_region_postprocess_matches_jax(predictors, thresholds,
                                              width):
    frame = make_frame(1, width)
    got = _amg(predictors[1], *thresholds,
               min_mask_region_area=12).generate(frame)
    ref = _amg(predictors[0], *thresholds,
               min_mask_region_area=12).generate(frame)
    _assert_same_records(got, ref)


# ---------------------------------------------------------------------------
# prompts_grid
# ---------------------------------------------------------------------------

def _assert_same_prompt_json(got, ref):
    assert (got["video_id"], got["bin_size"]) == (ref["video_id"],
                                                  ref["bin_size"])
    assert len(got["prompt_masks"]) == len(ref["prompt_masks"]) > 0
    for a, b in zip(got["prompt_masks"], ref["prompt_masks"]):
        assert set(a) == set(b)
        assert (a["frame_idx"], a["prompt_id"]) == (b["frame_idx"],
                                                    b["prompt_id"])
        got_mask = trle.decode(a["segmentation"])
        assert abs(a["area"] - b["area"]) <= PIX_FRAC * got_mask.size
        np.testing.assert_allclose(a["area_ratio"], b["area_ratio"],
                                   atol=PIX_FRAC)
        np.testing.assert_allclose(a["stability_score"],
                                   b["stability_score"], atol=SCORE_ATOL)
        _assert_masks_close(got_mask, jrle.decode(b["segmentation"]))


def test_suppress_parts_matches_jax():
    rng = np.random.default_rng(5)
    masks = np.zeros((6, 20, 30), np.float32)
    for i, (y, x, s) in enumerate([(0, 0, 18), (2, 2, 8), (10, 12, 9),
                                   (1, 1, 5), (12, 20, 7), (5, 5, 3)]):
        masks[i, y:y + s, x:x + s] = 1
    masks[4] = masks[4] * (rng.random((20, 30)) > 0.2)
    np.testing.assert_array_equal(tprompts.suppress_parts(masks),
                                  jprompts.suppress_parts(masks))


@pytest.mark.parametrize("bin_size", [2, 0])
def test_generate_video_prompts_matches_jax(predictors, thresholds, width,
                                            bin_size):
    """bin_size 2 runs frames 0, 2 and 4 of 6; bin_size 0 (eval mode)
    runs 2 frames, 0 and 3."""
    frames = [make_frame(t, width) for t in range(6)]
    names = [f"{t:05d}" for t in range(6)]
    ref = jprompts.generate_video_prompts(_amg(predictors[0], *thresholds),
                                          frames, names, "vid", bin_size)
    got = tprompts.generate_video_prompts(_amg(predictors[1], *thresholds),
                                          frames, names, "vid", bin_size)
    assert got["bin_size"] == (bin_size or 3)
    assert {p["frame_idx"] for p in got["prompt_masks"]} <= (
        {0, 2, 4} if bin_size else {0, 3})
    _assert_same_prompt_json(got, ref)


def _workspace(root, width, n_videos=3, n_frames=4):
    from PIL import Image
    base = os.path.join(root, "datasets", "mevis", "valid_u", "JPEGImages")
    for v in range(n_videos):
        d = os.path.join(base, f"vid{v}")
        os.makedirs(d)
        for t in range(n_frames):
            Image.fromarray(make_frame(t, width, seed=10 * v)).save(
                os.path.join(d, f"{t:05d}.png"))


def _prompt_dir(root):
    return os.path.join(root, "sam2_prompts", "grid_prompts", "mevis",
                        "valid_u")


@pytest.mark.parametrize("shard", ["bin0", "pid1_of_2"])
def test_main_matches_jax(predictors, thresholds, width, tmp_path, shard):
    """Both CLIs over one workspace: bin_size 0 gives 2 frames a video;
    --pid 1 --n_pids 2 takes every second video; a JSON already written is
    left alone (resume)."""
    argv = ["--data_root", str(tmp_path), "--bin_size", "0"]
    if shard == "pid1_of_2":
        argv = ["--data_root", str(tmp_path), "--bin_size", "2",
                "--pid", "1", "--n_pids", "2"]
    _workspace(str(tmp_path), width)
    outs = {}
    for name, pkg, pred in (("jax", jprompts, predictors[0]),
                            ("torch", tprompts, predictors[1])):
        root = str(tmp_path / name)
        extra = ["--device", "cpu"] if name == "torch" else []
        os.makedirs(_prompt_dir(root))
        if shard == "bin0":  # a finished video is skipped
            with open(os.path.join(_prompt_dir(root), "vid2.json"),
                      "w") as f:
                json.dump({"done": True}, f)
        pkg.main(argv + ["--output_root", root] + extra,
                 amg_factory=lambda pred=pred: _amg(pred, *thresholds))
        outs[name] = {}
        for fn in sorted(os.listdir(_prompt_dir(root))):
            with open(os.path.join(_prompt_dir(root), fn)) as f:
                outs[name][fn] = json.load(f)
    want = ({"vid0.json", "vid1.json", "vid2.json"} if shard == "bin0"
            else {"vid1.json"})
    assert set(outs["torch"]) == set(outs["jax"]) == want
    for fn, ref in outs["jax"].items():
        if ref.get("done"):
            assert outs["torch"][fn] == ref
            continue
        _assert_same_prompt_json(outs["torch"][fn], ref)
        assert ref["bin_size"] == 2


def test_downscaled_frame_drift_is_bounded(all_predictors):
    """The port's own resize on a frame wider than the model (72 px into
    64): its antialiased linear resize differs from jax.image.resize in the
    last bits, and the uint8 truncation after it moves some pixels of flat
    regions by one gray level. The scores drift, but stay within 1e-3."""
    jpred, tpred, _ = all_predictors
    frame = make_frame(1, 72)
    for pred in (jpred, tpred):
        pred.set_image(frame)
    pts = grid_points(72)[:, None]
    ji, js, _ = jpred.propose(pts)
    ti, ts, _ = tpred.propose(pts)
    assert np.abs(ti - ji).max() <= 1e-3
    assert np.abs(ts - js).max() <= 2e-2
