"""The port's GroundingDINO against the JAX package's at
GDINOConfig.tiny_test, fp32 on the CPU, with the JAX weights carried across
through state_dict_from_jax_params. The JAX model is the one build_gdino
makes (its init, jitted). Module outputs agree within 1e-4, boxes in pixels
within 1e-3, and the -inf pattern of the logits exactly."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sola_tpu.models import text as jtext
from sola_tpu.trackgen.gdino import convert as jconvert
from sola_tpu.trackgen.gdino import model as jgd
from sola_tpu.trackgen.gdino import swin as jswin
from sola_torch.models import text as ttext
from sola_torch.trackgen.gdino import convert as tconvert
from sola_torch.trackgen.gdino import model as tgd
from sola_torch.trackgen.gdino import swin as tswin

ATOL = 1e-4
TEXTS = ["the red car.", "a dog running.", "the tallest person."]


def jax_gdino(cfg, seed=0):
    """build_gdino's model and variables (numpy leaves), with its init
    jitted."""
    model = jgd.GroundingDINO(cfg)
    s = cfg.size_target
    variables = jax.jit(model.init)(
        jax.random.PRNGKey(seed), jnp.zeros((1, s, s, 3), jnp.float32),
        jnp.ones((1, s, s), bool), jnp.zeros((1, 8), jnp.int32),
        jnp.ones((1, 8), jnp.int32))
    return model, jax.tree_util.tree_map(np.asarray, variables)


def port_gdino(variables, cfg):
    model = tgd.GroundingDINO(cfg)
    model.load_state_dict(tconvert.state_dict_from_jax_params(variables, cfg),
                          strict=True)
    return model.eval()


@pytest.fixture(scope="module")
def models():
    torch.set_num_threads(2)
    cfg = tgd.GDINOConfig.tiny_test()
    jmodel, variables = jax_gdino(jgd.GDINOConfig.tiny_test())
    return jmodel, variables, port_gdino(variables, cfg)


@pytest.fixture(scope="module")
def image():
    return np.random.default_rng(7).integers(0, 255, (48, 72, 3),
                                             dtype=np.uint8)


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(t, j, atol=ATOL):
    np.testing.assert_allclose(t.detach().float().numpy(), np.asarray(j),
                               atol=atol, rtol=0)


def test_converter_round_trip(models):
    """hf_gdino_to_params(state_dict_from_jax_params(v)) == v leaf for
    leaf, with full coverage by both packages' measure."""
    jmodel, variables, model = models
    sd = tconvert.state_dict_from_jax_params(variables, model.cfg)
    back = jconvert.hf_gdino_to_params(sd, jmodel.cfg)
    assert jconvert.conversion_coverage(variables, back) == 1.0
    assert tconvert.conversion_coverage(variables, back) == 1.0
    flat_v = jax.tree_util.tree_leaves_with_path(variables["params"])
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back["params"]))
    assert len(flat_v) == len(flat_b)
    for path, leaf in flat_v:
        np.testing.assert_array_equal(flat_b[path], leaf, err_msg=str(path))


def test_checkpoint_loading(models, tmp_path):
    """An HF-named checkpoint loads through build_gdino_from_checkpoint
    with full coverage; IDEA keys translate as in the JAX package."""
    _, variables, model = models
    path = str(tmp_path / "gdino_hf.pth")
    torch.save({"model": model.state_dict()}, path)
    loaded, report = tconvert.build_gdino_from_checkpoint(path, model.cfg)
    assert report["coverage"] == 1.0 and not report["missing"]
    for k, v in model.state_dict().items():
        torch.testing.assert_close(loaded.state_dict()[k], v, atol=0, rtol=0)
    rng = np.random.default_rng(0)
    idea = {"module.backbone.0.layers.1.blocks.0.attn.qkv.weight":
            rng.standard_normal((12, 4)).astype(np.float32),
            "transformer.decoder.layers.0.ca_text.in_proj_bias":
            rng.standard_normal(6).astype(np.float32),
            "transformer.encoder.fusion_layers.2.gamma_v":
            rng.standard_normal(3).astype(np.float32),
            "transformer.tgt_embed.weight": np.ones((2, 3), np.float32),
            "bert.pooler.dense.weight": np.ones((3, 3), np.float32)}
    want = jconvert.idea_to_hf_keys(dict(idea))
    got = tconvert.idea_to_hf_keys(dict(idea))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]))


def test_swin_matches_jax(models):
    jmodel, variables, model = models
    x = np.random.default_rng(1).standard_normal((1, 64, 64, 3)).astype(
        np.float32)
    ref = jswin.SwinTransformer(jmodel.cfg.swin).apply(
        {"params": variables["params"]["backbone"]}, jnp.asarray(x))
    with torch.no_grad():
        out = model.model.backbone.conv_encoder.model(_t(x))
    assert len(out) == len(ref) == 3
    for o, r in zip(out, ref):
        _close(o, r)


def test_swin_base_matches_jax(models):
    """Swin-B (SwinConfig.base(): embed 128, heads 4 / 8 / 16 / 32, window
    12) with only its depths cut, to 2 blocks a stage, on a 192 x 192
    image, so stage 1's 48 x 48 tokens run plain and shifted 12-token
    windows; its JAX weights cross through state_dict_from_jax_params."""
    jmodel, variables, model = models
    depths = (2, 2, 2, 2)
    jcfg = dataclasses.replace(jswin.SwinConfig.base(), depths=depths)
    tcfg = dataclasses.replace(tgd.SwinConfig.base(), depths=depths)
    assert (tcfg.embed_dim, tcfg.num_heads, tcfg.window_size) == (
        128, (4, 8, 16, 32), 12)
    x = np.random.default_rng(2).standard_normal((1, 192, 192, 3)).astype(
        np.float32)
    jswin_b = jswin.SwinTransformer(jcfg)
    swin_vars = jax.jit(jswin_b.init)(jax.random.PRNGKey(3), jnp.asarray(x))
    ref = jswin_b.apply(swin_vars, jnp.asarray(x))
    # the whole model's converter, with Swin-B in the backbone's place
    sd = tconvert.state_dict_from_jax_params(
        {"params": {**variables["params"], "backbone": swin_vars["params"]}},
        dataclasses.replace(model.cfg, swin=tcfg))
    prefix = "model.backbone.conv_encoder.model."
    port = tswin.SwinTransformer(tcfg, image_hw=(192, 192))
    port.load_state_dict({k[len(prefix):]: torch.as_tensor(np.asarray(v))
                          for k, v in sd.items() if k.startswith(prefix)},
                         strict=True)
    with torch.no_grad():
        out = port(_t(x))
    assert [tuple(o.shape) for o in out] == [(1, 24, 24, 256),
                                             (1, 12, 12, 512),
                                             (1, 6, 6, 1024)]
    assert len(out) == len(ref) == 3
    for o, r in zip(out, ref):
        _close(o, r)


def test_bert_3d_mask_matches_jax(models):
    jmodel, variables, model = models
    ids = np.array([[0, 17, 33, 2, 45, 2, 0, 0],
                    [0, 9, 2, 0, 0, 0, 0, 0]], np.int32)
    tmask = (np.arange(8)[None] < np.array([[6], [3]])).astype(np.int32)
    smask, pids = jgd.generate_special_token_masks(ids, (0, 2))
    tsmask, tpids = tgd.generate_special_token_masks(ids, (0, 2))
    np.testing.assert_array_equal(tsmask, smask)
    np.testing.assert_array_equal(tpids, pids)
    smask = smask & (tmask[:, None, :] > 0) & (tmask[:, :, None] > 0)
    smask |= np.eye(8, dtype=bool)[None]
    ref = jtext.RobertaEncoder(jmodel.cfg.text).apply(
        {"params": variables["params"]["bert"]}, jnp.asarray(ids),
        jnp.asarray(smask), position_ids=jnp.asarray(pids))
    with torch.no_grad():
        out = model.model.text_backbone(_t(ids), _t(smask),
                                        position_ids=_t(pids))
    _close(out, ref)
    np.testing.assert_array_equal(
        ttext.create_position_ids(_t(ids), 0).numpy(),
        np.asarray(jtext.create_position_ids(jnp.asarray(ids), 0)))


def test_forward_matches_jax(models, image):
    """Expression batching: one image, three text rows (one Swin pass
    broadcast to E)."""
    jmodel, variables, model = models
    gm = tgd.GroundingModel(model)
    toks = [gm._tokenize(t) for t in TEXTS]
    ids, tmask, smask, pids = (np.concatenate([t[i] for t in toks])
                               for i in range(4))
    canvas, pmask, _ = jgd.preprocess_image(image, jmodel.cfg)
    ref = jax.jit(jmodel.apply)(variables, canvas[None], pmask[None],
                                jnp.asarray(ids), jnp.asarray(tmask),
                                jnp.asarray(smask), jnp.asarray(pids))
    tcanvas, tpmask, _ = tgd.preprocess_image(image, model.cfg)
    with torch.no_grad():
        out = model(tcanvas[None], tpmask[None], _t(ids), _t(tmask),
                    _t(smask), _t(pids))
    for key in ("pred_boxes", "init_reference_points", "encoder_text"):
        _close(out[key], ref[key])
    logits, rlogits = out["pred_logits"].numpy(), np.asarray(
        ref["pred_logits"])
    assert logits.shape == rlogits.shape == (3, 20, 32)
    np.testing.assert_array_equal(np.isfinite(logits), np.isfinite(rlogits))
    np.testing.assert_array_equal(np.isneginf(logits), np.isneginf(rlogits))
    fin = np.isfinite(rlogits)
    assert fin.any() and not fin.all()
    np.testing.assert_allclose(logits[fin], rlogits[fin], atol=ATOL, rtol=0)


def _assert_same_preds(got, want, box_atol=1e-3):
    assert len(got) == len(want)
    for g_list, w_list in zip(got, want):
        assert len(g_list) == len(w_list) > 0
        for g, w in zip(g_list, w_list):
            assert g["phrase"] == w["phrase"]
            np.testing.assert_allclose(g["bbox"], w["bbox"], atol=box_atol,
                                       rtol=0)
            np.testing.assert_allclose(g["token_score"], w["token_score"],
                                       atol=ATOL, rtol=0)


def test_get_boxes_many_matches_jax(models, image):
    jmodel, variables, model = models
    jgm = jgd.GroundingModel(jmodel, variables)
    gm = tgd.GroundingModel(model)
    want = jgm.get_boxes_many(image, TEXTS, box_threshold=-1.0)
    got = gm.get_boxes_many(image, TEXTS, box_threshold=-1.0)
    _assert_same_preds(got, want)
    # a real threshold keeps the same queries
    thr = float(np.median([max(p["token_score"]) for p in want[0]]))
    _assert_same_preds(gm.get_boxes_many(image, TEXTS, thr),
                       jgm.get_boxes_many(image, TEXTS, thr))


def test_get_boxes_many_matches_sequential(models, image):
    """The expression batch mixes nothing: per-text get_boxes, and chunks
    of max_expr_batch, give the batched results."""
    _, _, model = models
    gm = tgd.GroundingModel(model)
    batched = gm.get_boxes_many(image, TEXTS, box_threshold=-1.0)
    _assert_same_preds(batched, [gm.get_boxes(image, t, box_threshold=-1.0)
                                 for t in TEXTS])
    gm.max_expr_batch = 2
    _assert_same_preds(gm.get_boxes_many(image, TEXTS, box_threshold=-1.0),
                       batched)


def test_get_boxes_many_texts_of_different_lengths(models, image):
    """Texts of different word counts batch together (each padded after
    its masks are made, its padding masked out) and give what each gives
    alone."""
    _, _, model = models
    gm = tgd.GroundingModel(model)
    texts = ["the red car.", "a green ellipse moving slowly to the left.",
             "dog."]
    _assert_same_preds(gm.get_boxes_many(image, texts, box_threshold=-1.0),
                       [gm.get_boxes(image, t, box_threshold=-1.0)
                        for t in texts])


@pytest.mark.parametrize("hw,full", [((48, 72), False), ((480, 854), False),
                                     ((480, 854), True)])
def test_preprocess_matches_jax(hw, full):
    """Upscale (48x72 and MeViS 480x854 at the 800x1333 canvas) and
    antialiased downscale (480x854 at the tiny 64 px canvas)."""
    img = np.random.default_rng(2).integers(0, 255, hw + (3,),
                                            dtype=np.uint8)
    jcfg = jgd.GDINOConfig() if full else jgd.GDINOConfig.tiny_test()
    tcfg = tgd.GDINOConfig() if full else tgd.GDINOConfig.tiny_test()
    canvas, mask, ohw = jgd.preprocess_image(img, jcfg)
    tcanvas, tmask, tohw = tgd.preprocess_image(img, tcfg)
    assert tohw == ohw
    np.testing.assert_array_equal(tmask.numpy(), np.asarray(mask))
    _close(tcanvas, canvas, 1e-5)


def test_bf16_compute_close_to_fp32(models, image):
    """bf16 compute (--bf16) runs end to end and proposes the same boxes
    as fp32 within the JAX package's own bf16 bound (random tiny weights:
    the top-k can swap a few near-tied queries)."""
    _, variables, model = models
    cfg = model.cfg
    gm32 = tgd.GroundingModel(model)
    gm16 = tgd.GroundingModel(port_gdino(variables, cfg),
                              compute_dtype=torch.bfloat16)
    p32 = gm32.get_boxes(image, TEXTS[0], box_threshold=-1.0)
    p16 = gm16.get_boxes(image, TEXTS[0], box_threshold=-1.0)
    assert len(p32) == len(p16)
    err = np.abs(np.stack([p["bbox"] for p in p16])
                 - np.stack([p["bbox"] for p in p32])).max(axis=1)
    assert (err < 3.0).mean() >= 0.8, err
    assert np.median(err) < 1.0, err


def test_configs_match_jax():
    for name in ("tiny_test",):
        j = dataclasses.asdict(getattr(jgd.GDINOConfig, name)())
        t = dataclasses.asdict(getattr(tgd.GDINOConfig, name)())
        t["text"].pop("type_vocab_size")
        assert t == j
    j, t = dataclasses.asdict(jgd.GDINOConfig()), dataclasses.asdict(
        tgd.GDINOConfig())
    t["text"].pop("type_vocab_size")
    assert t == j
    assert (dataclasses.asdict(tgd.SwinConfig.base())
            == dataclasses.asdict(jswin.SwinConfig.base()))
