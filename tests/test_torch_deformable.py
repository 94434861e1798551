"""The port's deformable sampling (the kernel's plain version, which the
wrapper runs on CPU tensors) against the JAX package's gather core and its
Pallas kernel in interpret mode, and the port's MSDeformAttn against the JAX
module with the same weights. fp32 agrees within 1e-5; bf16 values stay
within 1.5% of max|ref| (the JAX package's own bound for its kernel)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sola_tpu.ops.deformable_interp import ms_deform_attn_core_pallas
from sola_tpu.trackgen.gdino import deformable as jdeform
from sola_torch.ops import deformable_interp as di
from sola_torch.trackgen.gdino import deformable as tdeform

ATOL = 1e-5


def _make(rng, levels, lq, heads=4, head_dim=8, points=3, in_range=True):
    values = [rng.standard_normal((2, h, w, heads * head_dim)).astype(
        np.float32) for (h, w) in levels]
    span = (0.0, 1.0) if in_range else (-0.3, 1.3)
    loc = rng.uniform(*span, (2, lq, heads, len(levels), points, 2)).astype(
        np.float32)
    wgt = rng.random((2, lq, heads, len(levels), points))
    wgt = (wgt / wgt.sum(axis=(-1, -2), keepdims=True)).astype(np.float32)
    return values, loc, wgt


def _port(values, loc, wgt, dtype=torch.float32):
    return di.ms_deform_attn([torch.from_numpy(v).to(dtype) for v in values],
                             torch.from_numpy(loc), torch.from_numpy(wgt))


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


@pytest.mark.parametrize("case", ["in_range", "out_of_range", "ragged"])
def test_plain_core_matches_jax_gather_and_pallas(case):
    rng = np.random.default_rng({"in_range": 0, "out_of_range": 1,
                                 "ragged": 2}[case])
    if case == "ragged":
        # Lq 300 and HW 520 are multiples of neither Pallas tile (256, 512)
        values, loc, wgt = _make(rng, [(20, 26)], lq=300, heads=2,
                                 head_dim=16, points=2)
    else:
        values, loc, wgt = _make(rng, [(12, 16), (6, 8)], lq=40,
                                 in_range=case == "in_range")
    jv = [jnp.asarray(v) for v in values]
    gather = np.asarray(jdeform.ms_deform_attn_core(jv, jnp.asarray(loc),
                                                    jnp.asarray(wgt)))
    pallas = np.asarray(ms_deform_attn_core_pallas(
        jv, jnp.asarray(loc), jnp.asarray(wgt), interpret=True))
    before = di.launches
    got = _port(values, loc, wgt)
    assert di.launches == before  # CPU tensors take the plain version
    assert got.dtype == torch.float32 and got.shape == gather.shape
    np.testing.assert_allclose(got.numpy(), gather, atol=ATOL, rtol=0)
    np.testing.assert_allclose(got.numpy(), pallas, atol=ATOL, rtol=0)


def test_bf16_values_bounded_drift():
    """bf16 values: the port accumulates every level and point in fp32 and
    rounds once; the JAX gather core rounds after each level and the Pallas
    kernel rounds the combined weights to bf16. All stay within 1.5% of
    max|ref| of the fp32 result on the same bf16 values."""
    rng = np.random.default_rng(3)
    values, loc, wgt = _make(rng, [(12, 16), (6, 8)], lq=40, in_range=False)
    values = [np.array(jnp.asarray(v).astype(jnp.bfloat16).astype(
        jnp.float32)) for v in values]
    exact = _port(values, loc, wgt).numpy()
    got = _port(values, loc, wgt, torch.bfloat16)
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    v16 = [jnp.asarray(v).astype(jnp.bfloat16) for v in values]
    gather = np.asarray(jdeform.ms_deform_attn_core(
        v16, jnp.asarray(loc), jnp.asarray(wgt)), np.float32)
    pallas = np.asarray(ms_deform_attn_core_pallas(
        v16, jnp.asarray(loc), jnp.asarray(wgt), interpret=True), np.float32)
    scale = np.abs(exact).max()
    for other in (exact, gather, pallas):
        assert np.abs(got - other).max() <= 0.015 * scale
    # the port rounds once: within one bf16 half-ulp of the exact sum
    assert np.abs(got - exact).max() <= 2.0 ** -8 * scale


def test_flat_and_per_level_forms_agree():
    rng = np.random.default_rng(4)
    levels = [(7, 9), (4, 5), (2, 3)]
    values, loc, wgt = _make(rng, levels, lq=17, in_range=False)
    per_level = _port(values, loc, wgt)
    flat = torch.cat([torch.from_numpy(v).reshape(2, -1, v.shape[-1])
                      for v in values], dim=1)
    got = di.ms_deform_attn(flat, torch.from_numpy(loc),
                            torch.from_numpy(wgt), levels)
    torch.testing.assert_close(got, per_level, atol=0, rtol=0)
    with pytest.raises(ValueError, match="spatial shapes"):
        di._launch(flat, levels[:2], torch.from_numpy(loc)[:, :, :, :2],
                   torch.from_numpy(wgt)[:, :, :, :2])


def test_bilinear_sample_and_corner_terms():
    rng = np.random.default_rng(5)
    value = rng.standard_normal((2, 5, 7, 3)).astype(np.float32)
    loc = (rng.random((2, 11, 2)) * 1.2 - 0.1).astype(np.float32)
    ref = np.asarray(jdeform.bilinear_sample(jnp.asarray(value),
                                             jnp.asarray(loc)))
    got = tdeform.bilinear_sample(torch.from_numpy(value),
                                  torch.from_numpy(loc))
    np.testing.assert_allclose(got.numpy(), ref, atol=ATOL, rtol=0)
    # a far-out sample has no in-range corner; x = 0.99 keeps two of four
    idx, w = tdeform.corner_terms(torch.tensor([[-2.0, 0.5], [0.99, 0.5]]),
                                  4, 4)
    assert (w[0] == 0).all() and int((w[1] != 0).sum()) == 2
    assert (idx >= 0).all() and (idx < 16).all()


@pytest.mark.parametrize("ref_dims", [2, 4])
def test_msdeformattn_matches_jax(ref_dims):
    """Sampling offsets get nonzero weights (they init to zero), and padded
    values are zeroed after value_proj, as in the JAX module."""
    rng = np.random.default_rng(6)
    levels = [(8, 8), (4, 5)]
    d, heads, n_lv, points = 32, 4, 2, 2
    jmod = jdeform.MSDeformAttn(d_model=d, n_levels=n_lv, n_heads=heads,
                                n_points=points)
    q = rng.standard_normal((2, 10, d)).astype(np.float32)
    refp = rng.random((2, 10, n_lv, ref_dims)).astype(np.float32)
    vals = [rng.standard_normal((2, h, w, d)).astype(np.float32)
            for (h, w) in levels]
    mask = rng.random((2, sum(h * w for h, w in levels))) > 0.2
    params = jmod.init(jax.random.PRNGKey(0), jnp.asarray(q),
                       jnp.asarray(refp), [jnp.asarray(v) for v in vals])
    params = jax.tree_util.tree_map(np.asarray, params)
    off = params["params"]["sampling_offsets"]
    off["kernel"] = (rng.standard_normal(off["kernel"].shape) * 0.5).astype(
        np.float32)
    ref = jmod.apply(params, jnp.asarray(q), jnp.asarray(refp),
                     [jnp.asarray(v) for v in vals],
                     value_mask=jnp.asarray(mask))
    tmod = tdeform.MSDeformAttn(d, n_lv, heads, points)
    with torch.no_grad():
        for name, node in params["params"].items():
            lin = getattr(tmod, name)
            lin.weight.copy_(torch.from_numpy(node["kernel"].T.copy()))
            lin.bias.copy_(torch.from_numpy(node["bias"]))
        got = tmod(torch.from_numpy(q), torch.from_numpy(refp),
                   [torch.from_numpy(v) for v in vals],
                   value_mask=torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL,
                               rtol=0)
