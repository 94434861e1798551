"""The port's fused attention (its CPU path, the plain PyTorch version of
the CUDA kernel's function) against the JAX package's Pallas kernel in
interpret mode and against the dense reference. The kernel itself runs only
on the card; chip_smoke.py holds it against this plain version there."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sola_tpu.ops import flash_attention as jfa
from sola_torch.ops import flash_attention as tfa

ATOL = 3e-5


def dense_reference(q, k, v, key_mask=None):
    d = q.shape[-1]
    s = jnp.einsum("bhqd,bhkd->bhqk", q, k) / jnp.sqrt(jnp.asarray(d,
                                                                   q.dtype))
    if key_mask is not None:
        s = jnp.where(key_mask[:, None, None, :], s, -1e30)
    p = jax.nn.softmax(s, axis=-1)
    return jnp.einsum("bhqk,bhkd->bhqd", p, v)


def _inputs(seed, b, h, lq, lk, d):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, h, lq, d), dtype=np.float32)
    k = rng.standard_normal((b, h, lk, d), dtype=np.float32)
    v = rng.standard_normal((b, h, lk, d), dtype=np.float32)
    return q, k, v


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


def test_sam2_memory_shape_masked():
    """SAM2 memory-attention shape: 1 head, head_dim 256, long keys."""
    q, k, v = _inputs(0, 1, 1, 64, 600, 256)
    mask = np.ones((1, 600), bool)
    mask[0, 500:] = False
    ref = jfa.fused_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              key_mask=jnp.asarray(mask))
    out = tfa.fused_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), torch.from_numpy(mask))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)
    dense = dense_reference(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            jnp.asarray(mask))
    np.testing.assert_allclose(out.numpy(), np.asarray(dense), atol=ATOL)


@pytest.mark.parametrize("d", [56, 72, 96, 128])
@pytest.mark.parametrize("masked", [False, True])
def test_ragged_against_pallas(d, masked):
    """Lq and Lk not block-aligned, head dims of the SAM2 family; out and
    lse against the Pallas kernel (its padded keys only differ on fully
    masked rows, which this mask avoids)."""
    b, h, lq, lk = 2, 2, 100, 130
    q, k, v = _inputs(d, b, h, lq, lk, d)
    mask = None
    if masked:
        rng = np.random.default_rng(d + 1)
        mask = rng.random((b, lk)) > 0.3
        mask[:, 0] = True
    jm = None if mask is None else jnp.asarray(mask)
    tm = None if mask is None else torch.from_numpy(mask)
    ref_out, ref_lse = jfa.fused_attention_lse(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), key_mask=jm,
        block_q=32, block_k=32)
    out, lse = tfa.fused_attention_lse(torch.from_numpy(q),
                                       torch.from_numpy(k),
                                       torch.from_numpy(v), tm)
    assert out.shape == (b, h, lq, d) and lse.shape == (b, h, lq)
    assert out.dtype == torch.float32 and lse.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_out), atol=ATOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(ref_lse), atol=ATOL)
    out2 = tfa.fused_attention(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(v), tm)
    np.testing.assert_array_equal(out2.numpy(), out.numpy())


def test_fully_masked_row_is_mean_of_values():
    """A row whose keys are all masked gives the mean of V over the real
    keys, the dense path's convention (sam2/memory.py:110-118)."""
    q, k, v = _inputs(5, 2, 1, 24, 130, 72)
    mask = np.ones((2, 130), bool)
    mask[1] = False
    out, lse = tfa.fused_attention_lse(torch.from_numpy(q),
                                       torch.from_numpy(k),
                                       torch.from_numpy(v),
                                       torch.from_numpy(mask))
    dense = dense_reference(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            jnp.asarray(mask))
    np.testing.assert_allclose(out.numpy(), np.asarray(dense), atol=ATOL)
    np.testing.assert_allclose(out.numpy()[1, 0],
                               np.broadcast_to(v[1, 0].mean(0), (24, 72)),
                               atol=ATOL)
    assert np.all(lse.numpy()[1] < -1e29)


def test_masked_keys_do_not_leak():
    q, k, v = _inputs(6, 1, 2, 16, 40, 32)
    mask = np.ones((1, 40), bool)
    mask[0, 25:] = False
    out = tfa.fused_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                              key_mask=torch.from_numpy(mask))
    k[0, :, 30] = 999.0
    v[0, :, 30] = -999.0
    out2 = tfa.fused_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                               key_mask=torch.from_numpy(mask))
    np.testing.assert_allclose(out2.numpy(), out.numpy(), atol=ATOL)


def test_bf16_plain_version_casts_p_like_the_kernel():
    """bf16 inputs: fp32 statistics, out in bf16, lse fp32, and within bf16
    rounding of the fp32 result."""
    q, k, v = _inputs(7, 1, 2, 40, 70, 72)
    tq, tk, tv = (torch.from_numpy(x).bfloat16() for x in (q, k, v))
    out, lse = tfa.fused_attention_lse(tq, tk, tv)
    assert out.dtype == torch.bfloat16 and lse.dtype == torch.float32
    ref, ref_lse = tfa.attention_reference(tq.float(), tk.float(),
                                           tv.float())
    np.testing.assert_allclose(out.float().numpy(), ref.numpy(), atol=3e-2)
    np.testing.assert_allclose(lse.numpy(), ref_lse.numpy(), atol=1e-5)


def test_dropout_needs_a_seed_and_a_rate_below_one():
    """Dropout itself is held in tests/test_torch_flash_backward.py; what
    stays refused is a rate without a seed, as in the JAX package, and a
    rate of 1 or more."""
    q, k, v = (torch.from_numpy(x) for x in _inputs(8, 1, 1, 8, 8, 8))
    with pytest.raises(ValueError, match="dropout_seed"):
        tfa.fused_attention(q, k, v, dropout_rate=0.1)
    with pytest.raises(ValueError, match="dropout rate"):
        tfa.fused_attention(q, k, v, dropout_rate=1.0,
                            dropout_seed=torch.tensor([1]))


def test_cpu_path_counts_no_launch():
    before = tfa.launches
    q, k, v = (torch.from_numpy(x) for x in _inputs(9, 1, 1, 8, 8, 8))
    tfa.fused_attention(q, k, v)
    assert tfa.launches == before

