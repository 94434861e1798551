"""The port's SAM2 modules against the JAX package's at SAM2Config.tiny_test,
fp32 on the CPU, with the JAX weights carried across through
state_dict_from_jax_params. The fused-attention thresholds are lowered on
both sides in the ``fused`` cases so the kernel route runs (the port's CPU
route is the kernel's plain version; the JAX route is Pallas in interpret
mode)."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from sola_tpu.ops import flash_attention as jfa
from sola_tpu.trackgen.sam2 import common as jcommon
from sola_tpu.trackgen.sam2 import hiera as jhiera
from sola_tpu.trackgen.sam2 import memory as jmemory
from sola_tpu.trackgen.sam2.convert import params_to_torch_sam2
from sola_tpu.trackgen.sam2.model import SAM2Config as JConfig
from sola_tpu.trackgen.sam2.model import SAM2Model as JModel
from sola_torch.core.mask_ops import resize_bilinear
from sola_torch.trackgen.sam2 import common as tcommon
from sola_torch.trackgen.sam2 import hiera as thiera
from sola_torch.trackgen.sam2 import memory as tmemory
from sola_torch.trackgen.sam2.convert import state_dict_from_jax_params
from sola_torch.trackgen.sam2.model import SAM2Config, SAM2Model

ATOL = 1e-4


class _LowHieraAttn(jhiera.MultiScaleAttention):
    fused_min_tokens: int = 1


class _LowRoPE(jmemory.RoPEAttention):
    fused_min_keys: int = 1


@pytest.fixture(scope="module")
def models():
    torch.set_num_threads(2)
    jcfg = JConfig.tiny_test(image_size=64)
    jmodel = JModel(jcfg)
    variables = jmodel.init(jax.random.PRNGKey(0),
                            jnp.zeros((1, 64, 64, 3), jnp.float32))
    variables = jax.tree_util.tree_map(np.asarray, variables)
    cfg = SAM2Config.tiny_test(image_size=64)
    model = SAM2Model(cfg)
    model.load_state_dict(state_dict_from_jax_params(variables, cfg),
                          strict=True)
    model.eval()
    return jmodel, variables, model


def _lower_thresholds(monkeypatch, model, fused: bool) -> dict:
    """Lower both packages' fused thresholds; returns call counts of the
    two fused_attention entry points, so a test can show both ran."""
    calls = {"jax": 0, "torch": 0}
    if not fused:
        return calls

    def spy(fn, key):
        def wrapped(*args, **kwargs):
            calls[key] += 1
            return fn(*args, **kwargs)
        return wrapped

    monkeypatch.setattr(jfa, "fused_attention",
                        spy(jfa.fused_attention, "jax"))
    for mod in (thiera, tmemory):
        monkeypatch.setattr(mod, "fused_attention",
                            spy(mod.fused_attention, "torch"))
    monkeypatch.setattr(jhiera, "MultiScaleAttention", _LowHieraAttn)
    monkeypatch.setattr(jmemory, "RoPEAttention", _LowRoPE)
    for m in model.modules():
        if isinstance(m, thiera.MultiScaleAttention):
            monkeypatch.setattr(m, "fused_min_tokens", 1)
        if isinstance(m, tmemory.RoPEAttention):
            monkeypatch.setattr(m, "fused_min_keys", 1)
    return calls


def _close(t, j, atol=ATOL):
    np.testing.assert_allclose(t.detach().float().numpy(), np.asarray(j),
                               atol=atol, rtol=0)


def _t(x):
    return torch.from_numpy(np.asarray(x))


def test_state_dict_matches_params_to_torch_sam2(models):
    jmodel, variables, model = models
    ref = params_to_torch_sam2(variables, jmodel.cfg)
    ours = state_dict_from_jax_params(variables, model.cfg)
    assert sorted(ours) == sorted(ref)
    assert sorted(ours) == sorted(model.state_dict())
    for key, val in ref.items():
        np.testing.assert_array_equal(ours[key].numpy(), np.asarray(val),
                                      err_msg=key)


@pytest.mark.parametrize("fused", [False, True])
def test_encode_image(models, monkeypatch, fused):
    jmodel, variables, model = models
    calls = _lower_thresholds(monkeypatch, model, fused)
    rng = np.random.default_rng(1)
    img = rng.standard_normal((2, 64, 64, 3)).astype(np.float32)
    ref = jmodel.apply(variables, jnp.asarray(img),
                       method=JModel.encode_image)
    with torch.no_grad():
        out = model.encode_image(_t(img))
    for key in ("s0", "s1", "pix", "pos"):
        _close(out[key], ref[key])
    assert (calls["jax"] > 0 and calls["torch"] > 0) == fused


def test_encode_image_bf16_compute(models, monkeypatch):
    """bf16 compute as the video predictors set it up: the JAX package casts
    every parameter and the image to bf16, and its fp32 position embedding
    promotes the encoder after the patch embedding to fp32 (kernel route
    included); cast_for_compute must give the same numbers, in fp32."""
    from sola_torch.trackgen.sam2.video import cast_for_compute
    jmodel, variables, model = models
    bf16_model = SAM2Model(model.cfg)
    bf16_model.load_state_dict(model.state_dict(), strict=True)
    cast_for_compute(bf16_model, torch.bfloat16).eval()
    calls = _lower_thresholds(monkeypatch, bf16_model, True)
    cvars = jax.tree_util.tree_map(
        lambda x: x.astype(jnp.bfloat16) if x.dtype == np.float32 else x,
        variables)
    img = np.random.default_rng(1).standard_normal(
        (2, 64, 64, 3)).astype(np.float32)
    ref = jmodel.apply(cvars, jnp.asarray(img).astype(jnp.bfloat16),
                       method=JModel.encode_image)
    with torch.no_grad():
        out = bf16_model.encode_image(_t(img).bfloat16())
    for key in ("s0", "s1", "pix", "pos"):
        assert out[key].dtype == torch.float32, key
        assert ref[key].dtype == jnp.float32, key
        _close(out[key], ref[key])
    assert calls["jax"] > 0 and calls["torch"] > 0


@pytest.mark.parametrize("multimask", [False, True])
@pytest.mark.parametrize("with_mask", [False, True])
def test_sam_heads(models, multimask, with_mask):
    jmodel, variables, model = models
    cfg = model.cfg
    rng = np.random.default_rng(2)
    b, d = 3, cfg.d_model
    pix = rng.standard_normal((b, 4, 4, d)).astype(np.float32)
    s0 = rng.standard_normal((b, 16, 16, d // 8)).astype(np.float32)
    s1 = rng.standard_normal((b, 8, 8, d // 4)).astype(np.float32)
    coords = rng.uniform(0, 64, (b, 2, 2)).astype(np.float32)
    labels = np.array([[1, -1], [0, 1], [2, 3]], np.int32)
    mask = (rng.standard_normal((b, 16, 16, 1)).astype(np.float32)
            if with_mask else None)
    ref = jmodel.apply(variables, jnp.asarray(pix), jnp.asarray(s0),
                       jnp.asarray(s1), jnp.asarray(coords),
                       jnp.asarray(labels),
                       None if mask is None else jnp.asarray(mask),
                       multimask, True, method=JModel.sam_heads)
    with torch.no_grad():
        out = model.sam_heads(_t(pix), _t(s0), _t(s1), _t(coords),
                              _t(labels).long(),
                              None if mask is None else _t(mask), multimask,
                              True)
    for key in ("low_res_masks", "high_res_masks", "ious", "obj_ptr",
                "object_score_logits"):
        _close(out[key], ref[key])


def test_mask_as_output_and_encode_memory(models):
    jmodel, variables, model = models
    cfg = model.cfg
    rng = np.random.default_rng(3)
    b, d = 2, cfg.d_model
    pix = rng.standard_normal((b, 4, 4, d)).astype(np.float32)
    s0 = rng.standard_normal((b, 16, 16, d // 8)).astype(np.float32)
    s1 = rng.standard_normal((b, 8, 8, d // 4)).astype(np.float32)
    masks = (rng.random((b, 64, 64)) > 0.6).astype(np.float32)
    masks[1] = 0.0
    ref = jmodel.apply(variables, jnp.asarray(pix), jnp.asarray(s0),
                       jnp.asarray(s1), jnp.asarray(masks),
                       method=JModel.mask_as_output)
    ref_mem = jmodel.apply(variables, jnp.asarray(pix),
                           ref["high_res_masks"][:, 0],
                           method=JModel.encode_memory)
    with torch.no_grad():
        out = model.mask_as_output(_t(pix), _t(s0), _t(s1), _t(masks))
        mem = model.encode_memory(_t(pix), out["high_res_masks"][:, 0])
    for key in ("low_res_masks", "high_res_masks", "obj_ptr",
                "object_score_logits"):
        _close(out[key], ref[key])
    _close(mem, ref_mem)


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("empty_row", [False, True])
def test_condition_features(models, monkeypatch, fused, empty_row):
    jmodel, variables, model = models
    calls = _lower_thresholds(monkeypatch, model, fused)
    cfg = model.cfg
    rng = np.random.default_rng(4)
    b, h, d, m = 2, cfg.feat_hw, cfg.d_model, cfg.mem_dim
    r, p = cfg.num_recent, cfg.max_obj_ptrs
    pix = rng.standard_normal((b, h, h, d)).astype(np.float32)
    pos = rng.standard_normal((b, h, h, d)).astype(np.float32)
    cond = rng.standard_normal((b, 1, h, h, m)).astype(np.float32)
    cond_valid = np.array([[True], [not empty_row]])
    rec = rng.standard_normal((b, r, h, h, m)).astype(np.float32)
    rec_valid = rng.random((b, r)) > 0.4
    if empty_row:
        rec_valid[1] = False
    rec_tpos = rng.integers(1, r + 1, (b, r)).astype(np.int32)
    ptrs = rng.standard_normal((b, p, d)).astype(np.float32)
    ptr_valid = rng.random((b, p)) > 0.5
    args = (pix, pos, cond, cond_valid, rec, rec_valid, rec_tpos, ptrs,
            ptr_valid)
    ref = jmodel.apply(variables, *(jnp.asarray(a) for a in args),
                       method=JModel.condition_features)
    with torch.no_grad():
        out = model.condition_features(*(_t(a) for a in args))
    _close(out, ref)
    assert (calls["jax"] > 0 and calls["torch"] > 0) == fused


def test_rope_tables_and_rotation():
    rng = np.random.default_rng(5)
    cos, sin = tmemory.axial_rope_freqs(32, 4, 4)
    jcos, jsin = jmemory.axial_rope_freqs(32, 4, 4)
    _close(cos, jcos, 1e-6)
    _close(sin, jsin, 1e-6)
    x = rng.standard_normal((2, 1, 48, 32)).astype(np.float32)
    _close(tmemory.apply_rope(_t(x), cos, sin),
           jmemory.apply_rope(jnp.asarray(x), jcos, jsin), 1e-6)


@pytest.mark.parametrize("hw,out", [
    ((720, 1280), (1024, 1024)),   # frame downscale (video.py:123)
    ((480, 854), (270, 480)),
    ((16, 16), (64, 64)),          # low-res logits upscale
    ((64, 64), (960, 540)),        # canonical small masklet
    ((256, 256), (480, 854)),
])
def test_resize_bilinear_matches_jax(hw, out):
    rng = np.random.default_rng(6)
    x = rng.random((2,) + hw).astype(np.float32)
    ref = jax.image.resize(jnp.asarray(x), (2,) + out, method="linear")
    _close(resize_bilinear(_t(x), out), ref, 1e-6)


def test_nearest_and_bicubic_helpers():
    rng = np.random.default_rng(7)
    x = rng.standard_normal((1, 8, 8, 3)).astype(np.float32)
    ref = jax.image.resize(jnp.asarray(x), (1, 32, 32, 3), method="nearest")
    _close(tcommon.interpolate_nearest(_t(x), 32, 32), ref, 0)
    y = rng.standard_normal((7, 7, 5)).astype(np.float32)
    want = F.interpolate(_t(y).permute(2, 0, 1)[None], size=(16, 16),
                         mode="bicubic", align_corners=False)[0]
    _close(tcommon.torch_bicubic_resize(_t(y), 16, 16),
           want.permute(1, 2, 0).numpy(), 1e-5)
    _close(tcommon.sine_position_encoding(4, 6, 32),
           jcommon.sine_position_encoding(4, 6, 32), 1e-6)
