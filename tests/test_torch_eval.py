"""Selection eval and inference in both packages on one tiny synthetic
corpus and one ``epoch_0.pth``: ``sola_tpu.cli.eval`` against
``sola_torch.cli.eval --device cpu`` (equal confusion counts, every float of
the metrics JSON within 1e-5 relative, a score std also within 1e-6
absolute, J / F / J&F within 1e-6), both
inference CLIs (byte-equal PNGs), ``eval/metrics.py`` against its original,
and the main path chained at tiny size in each package: prompts_grid ->
tokens_grid -> eval, giving the same J&F JSONs.

Both packages' hash text encoders draw their tables from their own
generators, so the port's gets the JAX table, as tests/test_torch_train.py
does."""

import dataclasses
import json
import math
import os

import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp

from sola_tpu.cli import eval as jeval_cli
from sola_tpu.cli import inference as jinfer_cli
from sola_tpu.eval import evaluator as jevaluator
from sola_tpu.eval import inference as jinference
from sola_tpu.eval import metrics as jmetrics
from sola_tpu.models.text import HashTextEncoder as JHashText
from sola_tpu.trackgen import prompts_grid as jprompts
from sola_tpu.trackgen import tokens_grid as jtokens
from sola_tpu.trackgen.sam2.amg import SAM2AutomaticMaskGenerator as JAMG
from sola_tpu.trackgen.sam2.image import SAM2ImagePredictor as JImage
from sola_tpu.trackgen.sam2.model import SAM2Config as JSAM2Config
from sola_tpu.trackgen.sam2.model import SAM2Model as JSAM2Model
from sola_tpu.trackgen.sam2.video import SAM2VideoPredictor as JVideo
from sola_torch.cli import eval as teval_cli
from sola_torch.cli import inference as tinfer_cli
from sola_torch.data import synthetic
from sola_torch.eval import evaluator as tevaluator
from sola_torch.eval import inference as tinference
from sola_torch.eval import metrics as tmetrics
from sola_torch.models.selection import SelectionConfig, SelectionModel
from sola_torch.models.selection import init_weights
from sola_torch.models.text import HashTextEncoder
from sola_torch.trackgen import prompts_grid as tprompts
from sola_torch.trackgen import tokens_grid as ttokens
from sola_torch.trackgen.sam2.amg import SAM2AutomaticMaskGenerator as TAMG
from sola_torch.trackgen.sam2.convert import state_dict_from_jax_params
from sola_torch.trackgen.sam2.image import SAM2ImagePredictor as TImage
from sola_torch.trackgen.sam2.model import SAM2Config, SAM2Model
from sola_torch.trackgen.sam2.video import SAM2VideoPredictor

# frames upscale on both axes to the tiny SAM2's 64 px (see test_torch_amg)
H, W, T = 48, 64, 6
LANG = 64
FLOAT_RTOL = 1e-5
# the scores are fp32 sigmoids whose two forwards differ by about 1e-6; a
# score std (the leaves *_score/1) moves by at most that, which the std of a
# few close scores (about 0.03) carries at 2e-5 of its size, so a std also
# passes within this absolute limit
STD_ATOL = 1e-6
JF_ATOL = 1e-6


def model_section(object_token_dim):
    return {"object_token_dim": object_token_dim, "lang_token_dim": LANG,
            "n_layers": 1, "max_temporal_length": 100, "n_negative": 4,
            "dropout_p": 0.0, "attn_dropout_p": 0.0, "norm_type": "group",
            "n_groups": 8, "n_groups_module": 8}


def write_config(root, name, dataset, object_token_dim):
    """A YAML config over ``dataset`` and its ``epoch_0.pth`` (seeded
    random weights) in the train output dir; returns the YAML's path."""
    configs = {
        "exp_name": name, "model": model_section(object_token_dim),
        "train": {"n_epochs": 1, "pred_threshold": 0.5, "temperature": 0.07,
                  "alignment_weight": 0.3, "lr": 1e-4,
                  "positive_metric": "iou", "positive_threshold": 0.7,
                  "positive_weight": 1.5},
        "dataset": dataset, "eval": {"pred_threshold": 0.5},
        "results": {"output_dir": os.path.join(root, "TRAIN"),
                    "eval_output_dir": os.path.join(root, "EVAL"),
                    "test_output_dir": os.path.join(root, "INFER")}}
    model = SelectionModel(SelectionConfig.from_dict(configs["model"]))
    init_weights(model, seed=7)
    out = os.path.join(root, "TRAIN", name, "mevis")
    os.makedirs(out, exist_ok=True)
    torch.save(model.state_dict(), os.path.join(out, "epoch_0.pth"))
    path = os.path.join(root, f"{name}.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(configs, f)
    return path


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """One synthetic valid_u corpus with JPEG frames; the test split is the
    same videos, so inference has tracks to merge."""
    torch.set_num_threads(2)
    root = str(tmp_path_factory.mktemp("torcheval"))
    gen = synthetic.generate(os.path.join(root, "data"), n_videos=2,
                             n_frames=T, h=H, w=W, n_objects=2,
                             n_distractors=2, write_frames=True)
    dataset = gen["configs"]
    for split in ("train", "valid", "test"):
        dataset[split]["batch_size"] = 2
    return {"root": root, "dataset": dataset,
            "yaml": write_config(root, "torcheval", dataset, 256)}


@pytest.fixture
def text_encoders(monkeypatch):
    """Both packages' evaluator and inference build a hash encoder with the
    JAX table."""
    table = np.asarray(JHashText(hidden_size=LANG).table)
    for mod in (jevaluator, jinference):
        monkeypatch.setattr(mod, "build_text_encoder",
                            lambda cfg: JHashText(hidden_size=LANG))
    for mod in (tevaluator, tinference):
        monkeypatch.setattr(mod, "build_text_encoder",
                            lambda cfg, device: HashTextEncoder(
                                hidden_size=LANG, table=table,
                                device=device))


def _eval_dir(root, pkg, name="torcheval"):
    return os.path.join(root, f"EVAL_{pkg}", name, "mevis",
                        "pred_threshold_05", "epoch_0")


def run_eval(pkg, root, yaml_path, name="torcheval"):
    """One package's eval CLI on a YAML and its checkpoint; returns the
    (metrics, JF) JSONs."""
    if pkg == "jax":
        jeval_cli.main(["--config", yaml_path, "--eval_weight_epoch", "0",
                        "--results.eval_output_dir",
                        os.path.join(root, "EVAL_jax")])
    else:
        teval_cli.main(["--config", yaml_path, "--eval_weight_epoch", "0",
                        "--results.eval_output_dir",
                        os.path.join(root, "EVAL_torch"), "--device", "cpu"])
    d = _eval_dir(root, pkg, name)
    with open(os.path.join(d, "valid_u_metrics_0epoch.json")) as f:
        metrics = json.load(f)
    with open(os.path.join(d, "valid_u_JF_metrics_0epoch.json")) as f:
        return metrics, json.load(f)


def _assert_close_floats(got, ref, path=""):
    if isinstance(ref, dict):
        assert set(got) == set(ref), path
        for k in ref:
            _assert_close_floats(got[k], ref[k], f"{path}/{k}")
    elif isinstance(ref, list):
        assert len(got) == len(ref), path
        for i, (a, b) in enumerate(zip(got, ref)):
            _assert_close_floats(a, b, f"{path}/{i}")
    elif isinstance(ref, float):
        atol = STD_ATOL if path.endswith("_score/1") else 0.0
        assert (math.isnan(got) and math.isnan(ref)) or math.isclose(
            got, ref, rel_tol=FLOAT_RTOL, abs_tol=atol), (path, got, ref)
    else:
        assert got == ref, (path, got, ref)


def _assert_same_jf(got, ref):
    assert set(got) == set(ref)
    for vid in ref:
        assert set(got[vid]) == set(ref[vid])
        for e, r in ref[vid].items():
            g = got[vid][e]
            assert g["expression"] == r["expression"]
            for k in ("J", "F", "JF"):
                assert abs(g[k] - r[k]) <= JF_ATOL, (vid, e, k, g[k], r[k])
                assert 0.0 <= g[k] <= 1.0


def test_eval_cli_matches_jax(corpus, text_encoders):
    (jm, jjf), (tm, tjf) = (run_eval(pkg, corpus["root"], corpus["yaml"])
                            for pkg in ("jax", "torch"))
    for k in ("tp", "fp", "fn", "tn"):
        assert tm[k] == jm[k], k
    assert tm["tp"] + tm["fp"] + tm["fn"] + tm["tn"] > 0
    _assert_close_floats(tm, jm)
    _assert_same_jf(tjf, jjf)
    assert len(tjf) == 2 and all(len(v) == 2 for v in tjf.values())


def test_inference_cli_pngs_equal_jax(corpus, text_encoders):
    root = corpus["root"]
    dirs = {}
    for pkg, main, extra in (("jax", jinfer_cli.main, []),
                             ("torch", tinfer_cli.main, ["--device", "cpu"])):
        out = os.path.join(root, f"INFER_{pkg}")
        main(["--config", corpus["yaml"], "--eval_weight_epoch", "0",
              "--results.test_output_dir", out] + extra)
        dirs[pkg] = os.path.join(out, "torcheval", "mevis",
                                 "pred_threshold_05", "epoch_0")
    pngs = {}
    for pkg, d in dirs.items():
        pngs[pkg] = {os.path.relpath(os.path.join(dp, f), d): open(
            os.path.join(dp, f), "rb").read()
            for dp, _, files in os.walk(d) for f in files}
    # 2 videos x 2 expressions x T frames
    assert len(pngs["torch"]) == 2 * 2 * T
    assert pngs["torch"] == pngs["jax"]


def test_load_weights_errors(corpus, tmp_path):
    from sola_torch import config as config_lib
    configs, device = teval_cli.get_configs(
        ["--config", corpus["yaml"], "--eval_weight_epoch", "3",
         "--device", "cpu"])
    assert device == "cpu"
    with pytest.raises(FileNotFoundError, match="no checkpoint for epoch 3"):
        teval_cli.load_weights(configs, "cpu")
    os.makedirs(os.path.join(config_lib.train_output_dir(configs),
                             "epoch_3"))
    with pytest.raises(ValueError, match="orbax"):
        teval_cli.load_weights(configs, "cpu")


def test_eval_step_without_labels(corpus):
    """A batch without GT (MeViS valid, the leaderboard split) gets scores
    and predictions only, equal to those of the same batch with labels."""
    from sola_torch.data.dataset import get_loader_dict
    from sola_torch.train.loop import eval_step, prepare_batch
    model = SelectionModel(SelectionConfig.from_dict(model_section(256)))
    init_weights(model, seed=7)
    train_cfg = {"temperature": 0.07, "alignment_weight": 0.3,
                 "positive_metric": "iou", "positive_threshold": 0.7,
                 "positive_weight": 1.5}
    dataset = json.loads(json.dumps(corpus["dataset"]))
    raw = next(iter(get_loader_dict(dataset, only_eval=True)["valid"]))
    text = HashTextEncoder(hidden_size=LANG)
    batch = prepare_batch(raw, text, train_cfg, "cpu")
    labelled = eval_step(model, batch, train_cfg, 0.5)
    batch.pop("labels")
    bare = eval_step(model, batch, train_cfg, 0.5)
    assert set(bare) == {"pred", "pred_score"}
    assert torch.equal(bare["pred_score"], labelled["pred_score"])
    assert torch.equal(bare["pred"], labelled["pred"])


def test_metrics_match_jax():
    rng = np.random.default_rng(0)
    for _ in range(5):
        n = 12
        gt = [10, 20, 30]
        corr = rng.choice([10, 20, 30, -1], n).tolist()
        labels = rng.integers(0, 2, n).tolist()
        preds = rng.integers(0, 2, n).tolist()
        assert tmetrics.recall_per_track(gt, preds, labels, corr) == \
            jmetrics.recall_per_track(gt, preds, labels, corr)
        assert tmetrics.recall_per_exp(gt, preds, labels, corr) == \
            jmetrics.recall_per_exp(gt, preds, labels, corr)


# ---------------------------------------------------------------------------
# the main path at tiny size: prompts_grid -> tokens_grid -> eval
# ---------------------------------------------------------------------------

def token_width_tiny(config_cls, d=256):
    """SAM2Config.tiny_test with a d-wide model: the selection datasets
    collate 256-d object tokens, the width of SAM2's obj_ptr."""
    cfg = config_cls.tiny_test(image_size=64)
    rep = dataclasses.replace
    return rep(cfg,
               image_encoder=rep(cfg.image_encoder, d_model=d),
               prompt_encoder=rep(cfg.prompt_encoder, embed_dim=d),
               mask_decoder=rep(cfg.mask_decoder, transformer_dim=d),
               memory_attention=rep(cfg.memory_attention, d_model=d),
               memory_encoder=rep(cfg.memory_encoder, in_dim=d))


def test_chained_main_path_matches_jax(corpus, text_encoders, tmp_path):
    """Each package runs its own prompts_grid and tokens_grid CLIs on the
    corpus's JPEG frames (tiny SAM2 at the token width 256, shared weights,
    fp32) and evaluates its own tracks: the track censuses and the J&F
    JSONs agree."""
    jmodel = JSAM2Model(token_width_tiny(JSAM2Config))
    variables = jax.tree_util.tree_map(np.asarray, jax.jit(jmodel.init)(
        jax.random.PRNGKey(2), jnp.zeros((1, 64, 64, 3), jnp.float32)))
    cfg = token_width_tiny(SAM2Config)

    def port_model():
        m = SAM2Model(cfg)
        m.load_state_dict(state_dict_from_jax_params(variables, cfg),
                          strict=True)
        return m

    jimage = JImage(jmodel, variables, compute_dtype=jnp.float32)
    # thresholds in gaps of JAX's scores on the first frame, so that about
    # half of the proposals pass each and no score sits on one
    from PIL import Image
    frame_dir = os.path.join(corpus["dataset"]["data_root"], "mevis",
                             "valid_u", "JPEGImages", "video_000")
    frame0 = np.asarray(Image.open(os.path.join(frame_dir, "00000.jpg")))
    jimage.set_image(frame0)
    from sola_tpu.trackgen.sam2.amg import build_point_grid
    pts = build_point_grid(8) * np.asarray([W, H], np.float32)
    ious, stabs, _ = jimage.propose(pts[:, None])
    iou_t = _gap_midpoint(ious.ravel(), 0.3, 0.6)
    stab_t = _gap_midpoint(stabs.ravel(), 0.2, 0.5)
    amg_kw = dict(points_per_side=8, points_per_batch=16,
                  pred_iou_thresh=iou_t, stability_score_thresh=stab_t)
    data_root = os.path.dirname(corpus["dataset"]["data_root"])
    base = ["--data_root", data_root, "--bin_size", "3"]
    censuses, yamls = {}, {}
    for pkg in ("jax", "torch"):
        root = str(tmp_path / pkg)
        argv = base + ["--output_root", root]
        if pkg == "jax":
            jprompts.main(argv, amg_factory=lambda: JAMG(jimage, **amg_kw))
            jtokens.main(argv + ["--batch_size", "2", "--save_prec_rec_iou"],
                         predictor_factory=lambda: JVideo(
                             jmodel, variables, obj_batch=2,
                             feature_dtype=jnp.float32,
                             compute_dtype=jnp.float32))
        else:
            argv = argv + ["--device", "cpu"]
            tprompts.main(argv, amg_factory=lambda: TAMG(TImage(
                port_model(), compute_dtype=torch.float32), **amg_kw))
            ttokens.main(argv + ["--batch_size", "2", "--save_prec_rec_iou"],
                         predictor_factory=lambda: SAM2VideoPredictor(
                             port_model(), obj_batch=2,
                             feature_dtype=torch.float32,
                             compute_dtype=torch.float32))
        with open(os.path.join(root, "sam2_tracks", "grid_tracks", "mevis",
                               "valid_u", "runtime_info_3.json")) as f:
            censuses[pkg] = {v: {k: c[k] for k in (
                "n_tracked", "n_filtered", "n_not_used", "n_total")}
                for v, c in json.load(f).items()}
        dataset = json.loads(json.dumps(corpus["dataset"]))
        dataset["track_root"] = os.path.join(root, "sam2_tracks")
        yamls[pkg] = write_config(str(tmp_path), f"chain_{pkg}", dataset,
                                  cfg.d_model)
    assert censuses["torch"] == censuses["jax"]
    assert all(c["n_tracked"] > 0 for c in censuses["torch"].values()), \
        censuses
    jf = {pkg: run_eval(pkg, str(tmp_path), yamls[pkg], f"chain_{pkg}")[1]
          for pkg in ("jax", "torch")}
    _assert_same_jf(jf["torch"], jf["jax"])


def _gap_midpoint(values, lo_q, hi_q):
    """Midpoint of the widest gap between neighbouring distinct values
    from the ``lo_q`` to the ``hi_q`` quantile."""
    v = np.unique(np.asarray(values, np.float64))
    v = v[int(lo_q * len(v)):int(hi_q * len(v)) + 1]
    i = int(np.argmax(np.diff(v)))
    return float(0.5 * (v[i] + v[i + 1]))
