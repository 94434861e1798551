"""The port's selection model against the JAX package's, with the JAX
weights carried across by ``state_dict_from_jax_params``: the layers, both
attention routes (the Pallas route runs its kernels in interpret mode; the
port's, on the CPU, their plain versions), the whole model with track,
frame and language masks, and the gradients of ``total_loss`` with respect
to every parameter at dropout 0 (and their norms by submodule)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sola_tpu.models import attention as jattn
from sola_tpu.models import convert as jconvert
from sola_tpu.models import layers as jlayers
from sola_tpu.models import selection as jsel
from sola_tpu.train import loss as jloss
from sola_tpu.train import state as jstate
from sola_torch.models import attention as tattn
from sola_torch.models import convert as tconvert
from sola_torch.models import layers as tlayers
from sola_torch.models import selection as tsel
from sola_torch.train import loss as tloss
from sola_torch.train import state as tstate

ATOL = 1e-4


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


def _t(x):
    return torch.from_numpy(np.array(x))


def small_cfg(**kw):
    base = dict(object_token_dim=16, lang_token_dim=64, n_layers=2,
                n_negative=4, dropout_p=0.0, n_groups=4, n_groups_module=4,
                attn_dropout_p=0.0)
    base.update(kw)
    return base


def _batch(seed=0, b=2, n=5, t=16, w=6, d_obj=16, d=64):
    rng = np.random.default_rng(seed)
    obj = rng.standard_normal((b, n, t, d_obj), dtype=np.float32)
    lang = rng.standard_normal((b, w, d), dtype=np.float32)
    track_mask = np.ones((b, n), bool)
    track_mask[1, 3:] = False
    frame_lengths = np.array([t, t - 5], np.int32)
    lang_mask = np.ones((b, w), bool)
    lang_mask[0, 4:] = False
    return obj, lang, track_mask, frame_lengths, lang_mask


def test_ws_conv1d_matches_jax():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, 17, 8), dtype=np.float32)
    mod = jlayers.WSConv1d(features=12, kernel_size=3, stride=2, padding=1)
    params = mod.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    ref = mod.apply({"params": params}, jnp.asarray(x))
    conv = tlayers.WSConv1d(8, 12, 3, 2, 1)
    conv.load_state_dict({
        "weight": _t(np.transpose(np.asarray(params["kernel"]), (2, 1, 0))),
        "bias": _t(params["bias"])})
    out = conv(_t(x))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                               atol=1e-5)


@pytest.mark.parametrize("masked", [False, True])
def test_masked_group_norm_matches_jax(masked):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((3, 9, 16), dtype=np.float32) * 3 + 1
    mask = rng.random((3, 9)) > 0.3 if masked else None
    mod = jlayers.MaskedGroupNorm(num_groups=4)
    params = {"scale": rng.standard_normal(16, dtype=np.float32),
              "bias": rng.standard_normal(16, dtype=np.float32)}
    ref = mod.apply({"params": params}, jnp.asarray(x),
                    None if mask is None else jnp.asarray(mask))
    norm = tlayers.MaskedGroupNorm(4, 16)
    norm.load_state_dict({"weight": _t(params["scale"]),
                          "bias": _t(params["bias"])})
    out = norm(_t(x), None if mask is None else _t(mask))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                               atol=1e-5)


def test_standardize_and_length_helpers_match_jax():
    rng = np.random.default_rng(3)
    k = rng.standard_normal((3, 5, 7), dtype=np.float32)  # (k, in, out)
    ref = np.asarray(jlayers.standardize_conv_kernel(jnp.asarray(k)))
    got = tlayers.standardize_conv_kernel(_t(np.transpose(k, (2, 1, 0))))
    np.testing.assert_allclose(np.transpose(got.numpy(), (2, 1, 0)), ref,
                               atol=1e-5)
    w = rng.standard_normal((6, 4), dtype=np.float32)  # (in, out)
    np.testing.assert_allclose(
        tlayers.standardize_dense_kernel(_t(w.T)).numpy().T,
        np.asarray(jlayers.standardize_dense_kernel(jnp.asarray(w))),
        atol=1e-5)
    lengths = np.array([16, 11, 1, 0], np.int32)
    np.testing.assert_array_equal(
        tlayers.downsampled_length(_t(lengths).long(), 2, 3, 1).numpy(),
        np.asarray(jlayers.downsampled_length(jnp.asarray(lengths), 2, 3,
                                              1)))
    np.testing.assert_array_equal(
        tlayers.prefix_mask(_t(lengths).long(), 16).numpy(),
        np.asarray(jlayers.prefix_mask(jnp.asarray(lengths), 16)))
    x = rng.standard_normal(20, dtype=np.float32)
    np.testing.assert_array_equal(tlayers.leaky_relu(_t(x)).numpy(),
                                  np.asarray(jlayers.leaky_relu(
                                      jnp.asarray(x))))


@pytest.mark.parametrize("use_pallas", [False, True])
def test_multi_head_attention_matches_jax(use_pallas):
    rng = np.random.default_rng(4)
    q = rng.standard_normal((2, 7, 64), dtype=np.float32)
    kv = rng.standard_normal((2, 11, 64), dtype=np.float32)
    mask = np.ones((2, 11), bool)
    mask[0, 8:] = False
    mod = jattn.MultiHeadAttention(embed_dim=64, num_heads=8, dropout_p=0.1,
                                   use_pallas=use_pallas)
    params = mod.init(jax.random.PRNGKey(0), jnp.asarray(q), jnp.asarray(kv),
                      jnp.asarray(kv))["params"]
    ref = mod.apply({"params": params}, jnp.asarray(q), jnp.asarray(kv),
                    jnp.asarray(kv), key_mask=jnp.asarray(mask))
    mha = tattn.MultiHeadAttention(64, 8, 0.1, use_pallas)
    mha.load_state_dict({f"{p}.{n}": _t(np.asarray(params[p][j]).T
                                        if j == "kernel" else params[p][j])
                         for p in ("q_proj", "k_proj", "v_proj", "out_proj")
                         for n, j in (("weight", "kernel"), ("bias", "bias"))})
    out = mha(_t(q), _t(kv), _t(kv), key_mask=_t(mask))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                               atol=ATOL)


@pytest.fixture(scope="module")
def jax_model():
    obj, lang, *_ = _batch()
    model = jsel.SelectionModel(jsel.SelectionConfig(**small_cfg()))
    variables = model.init(jax.random.PRNGKey(0), jnp.asarray(obj),
                           jnp.asarray(lang))
    return jax.device_get(variables)


def _torch_model(variables, **kw):
    model = tsel.SelectionModel(tsel.SelectionConfig(**small_cfg(**kw)))
    model.load_state_dict(tconvert.state_dict_from_jax_params(variables))
    return model


@pytest.mark.parametrize("use_pallas", [False, True])
def test_selection_forward_matches_jax(jax_model, use_pallas):
    obj, lang, tm, fl, lm = _batch()
    cfg = jsel.SelectionConfig(**small_cfg(use_pallas_attention=use_pallas))
    ref_logits, ref_tokens = jsel.SelectionModel(cfg).apply(
        jax_model, jnp.asarray(obj), jnp.asarray(lang),
        track_mask=jnp.asarray(tm), frame_lengths=jnp.asarray(fl),
        lang_mask=jnp.asarray(lm))
    model = _torch_model(jax_model, use_pallas_attention=use_pallas)
    logits, tokens = model(_t(obj), _t(lang), track_mask=_t(tm),
                           frame_lengths=_t(fl).long(), lang_mask=_t(lm))
    np.testing.assert_allclose(logits.detach().numpy(),
                               np.asarray(ref_logits), atol=ATOL, rtol=1e-4)
    np.testing.assert_allclose(tokens.detach().numpy(),
                               np.asarray(ref_tokens), atol=ATOL, rtol=1e-4)


def _loss_inputs(seed=5, b=2, n=5, d=64, m=4):
    rng = np.random.default_rng(seed)
    labels = (rng.random((b, n)) > 0.6).astype(np.float32)
    pos = rng.standard_normal((b, 1, d), dtype=np.float32)
    return labels, pos


LOSS_KW = dict(temperature=0.07, positive_weight=1.5, alignment_weight=0.3)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_total_loss_gradients_match_jax(jax_model, use_pallas):
    obj, lang, tm, fl, lm = _batch()
    labels, pos = _loss_inputs()
    cfg = jsel.SelectionConfig(**small_cfg(use_pallas_attention=use_pallas))
    jmodel = jsel.SelectionModel(cfg)

    def jax_loss(params):
        logits, tokens = jmodel.apply(
            {"params": params, "buffers": jax_model["buffers"]},
            jnp.asarray(obj), jnp.asarray(lang),
            track_mask=jnp.asarray(tm), frame_lengths=jnp.asarray(fl),
            lang_mask=jnp.asarray(lm), deterministic=False,
            rngs={"dropout": jax.random.PRNGKey(1)})
        neg = jnp.broadcast_to(params["negative_token"][None],
                               (2,) + params["negative_token"].shape)
        return jloss.total_loss(logits, tokens, jnp.asarray(labels),
                                jnp.asarray(pos), neg,
                                track_mask=jnp.asarray(tm), **LOSS_KW)[0]

    ref_loss, jax_grads = jax.value_and_grad(jax_loss)(jax_model["params"])
    ref_grads = tconvert.state_dict_from_jax_params(
        {"params": jax.device_get(jax_grads),
         "buffers": jax_model["buffers"]})

    model = _torch_model(jax_model, use_pallas_attention=use_pallas)
    logits, tokens = model(_t(obj), _t(lang), track_mask=_t(tm),
                           frame_lengths=_t(fl).long(), lang_mask=_t(lm),
                           deterministic=False,
                           generator=torch.Generator().manual_seed(0))
    loss, _ = tloss.total_loss(logits, tokens, _t(labels), _t(pos),
                               model.get_negative_tokens(2),
                               track_mask=_t(tm), **LOSS_KW)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(ref_loss),
                               rtol=1e-5)
    named = dict(model.named_parameters())
    assert set(named) == set(ref_grads) - {
        "positional_encoding_gaussian_matrix"}
    ref_norms = jstate.grad_norm_dict(jax_grads)
    norms = tstate.grad_norm_dict(model)
    assert set(norms) == set(ref_norms)
    for k, v in norms.items():
        np.testing.assert_allclose(float(v), float(ref_norms[k]), rtol=1e-4,
                                   err_msg=k)
    for name, p in named.items():
        ref = ref_grads[name].numpy()
        scale = max(np.abs(ref).max(), 1e-3)
        np.testing.assert_allclose(p.grad.numpy() / scale, ref / scale,
                                   atol=1e-4, err_msg=name)


def test_reference_state_dict_loads_strictly(jax_model):
    """params_to_torch_state_dict's output (the reference epoch_N.pth
    naming) loads into the port's model with strict=True, and the port's
    inverse converter gives the JAX tree back."""
    state = jconvert.params_to_torch_state_dict(jax_model, n_layers=2)
    model = tsel.SelectionModel(tsel.SelectionConfig(**small_cfg()))
    model.load_state_dict({k: _t(v) for k, v in state.items()}, strict=True)
    assert set(model.state_dict()) == set(state)
    back = tconvert.jax_params_from_state_dict(model.state_dict())
    for path, leaf in jax.tree_util.tree_leaves_with_path(jax_model):
        got = back
        for key in path:
            got = got[key.key]
        np.testing.assert_array_equal(got, np.asarray(leaf))


def test_training_forward_uses_its_generator(jax_model):
    """With dropout on, the forward is a function of its generator: the
    same seed gives the same output, another seed another, and the
    deterministic forward differs from both."""
    obj, lang, tm, fl, lm = _batch()
    model = _torch_model(jax_model, dropout_p=0.2, attn_dropout_p=0.1,
                         use_pallas_attention=True)
    args = (_t(obj), _t(lang), _t(tm), _t(fl).long(), _t(lm))
    a = model(*args, deterministic=False,
              generator=torch.Generator().manual_seed(7))[0]
    b = model(*args, deterministic=False,
              generator=torch.Generator().manual_seed(7))[0]
    c = model(*args, deterministic=False,
              generator=torch.Generator().manual_seed(8))[0]
    det = model(*args)[0]
    assert torch.equal(a, b)
    assert (a - c).abs().max() > 1e-6 and (a - det).abs().max() > 1e-6
    with pytest.raises(ValueError, match="generator"):
        model(*args, deterministic=False)


def test_seeded_init_is_deterministic_and_complete():
    cfg = tsel.SelectionConfig(**small_cfg())
    a, b = tsel.SelectionModel(cfg), tsel.SelectionModel(cfg)
    tsel.init_weights(a, 3)
    tsel.init_weights(b, 3)
    for (name, x), y in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(x, y), name
        assert torch.isfinite(x).all(), name
        if x.dim() >= 2:  # weights, negatives and the Fourier buffer
            assert x.std() > 0, name
