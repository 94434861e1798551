"""The port's host-side pieces against the JAX package's: torch mask
metrics with the empty-mask conventions, the masklet reshape, the nearest
resize, the RLE codec copy, and the engine's dedup IoU."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sola_tpu.core import mask_ops as jmask
from sola_tpu.core import rle as jrle
from sola_tpu.trackgen import engine as jengine
from sola_torch.core import mask_ops as tmask
from sola_torch.core import rle as trle
from sola_torch.trackgen import engine as tengine


def _masks(seed, shape, p=0.4):
    rng = np.random.default_rng(seed)
    m = (rng.random(shape) < p).astype(np.float32)
    m[0] = 0.0            # an empty frame in each masklet
    return m


def _pair():
    a = _masks(0, (5, 12, 16))
    b = _masks(1, (5, 12, 16))
    b[1] = 0.0            # pred empty, gt not
    a[2] = 0.0            # gt empty, pred not
    return a, b


@pytest.mark.parametrize("name", ["mask_iou", "masklet_iou", "compute_J",
                                  "compute_F", "partness"])
def test_scalar_metrics(name):
    a, b = _pair()
    if name == "partness":
        args = (a[1:], b[3])
    else:
        args = (a, b)
    ref = getattr(jmask, name)(*(jnp.asarray(x) for x in args))
    out = getattr(tmask, name)(*(torch.from_numpy(x) for x in args))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-6)


@pytest.mark.parametrize("reduction", ["mean", "none"])
def test_mask_metrics_conventions(reduction):
    a, b = _pair()
    ref = jmask.mask_metrics(jnp.asarray(a), jnp.asarray(b), reduction)
    out = tmask.mask_metrics(a, b, reduction)
    for o, r in zip(out, ref):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), atol=1e-6)
    j, f = tmask.compute_JF(a, b)
    rj, rf = jmask.compute_JF(jnp.asarray(a), jnp.asarray(b))
    np.testing.assert_allclose([float(j), float(f)], [float(rj), float(rf)],
                               atol=1e-6)


@pytest.mark.parametrize("hw", [(48, 80), (80, 48), (1080, 1920)])
def test_reshape_masklet_auto(hw):
    rng = np.random.default_rng(2)
    m = np.zeros((2,) + hw, np.float32)
    h, w = hw
    m[:, h // 4:3 * h // 4, w // 5:w // 2] = 1.0
    m[1, rng.integers(0, h, 50), rng.integers(0, w, 50)] = 1.0
    ref = np.asarray(jmask.reshape_masklet_auto(jnp.asarray(m)))
    out = tmask.reshape_masklet_auto(m).numpy()
    assert out.shape == ref.shape == (2,) + tmask.reshape_hw(h, w)
    assert (out != ref).mean() <= 1e-4


def test_resize_nearest_matches():
    x = np.arange(7 * 9, dtype=np.float32).reshape(7, 9)
    for out_hw in ((3, 4), (20, 31), (7, 9)):
        np.testing.assert_array_equal(tmask.resize_nearest_np(x, out_hw),
                                      jmask.resize_nearest_np(x, out_hw))


def test_rle_copy_is_byte_identical():
    m = _masks(3, (6, 33, 47))
    m[1] = 1.0
    enc_t = trle.encode_masklet(m)
    assert enc_t == jrle.encode_masklet(m)
    np.testing.assert_array_equal(trle.decode_masklet(enc_t),
                                  m.astype(np.uint8))
    assert [trle.area(r) for r in enc_t] == [int(x.sum()) for x in m]


def test_batched_dedup_ious_match():
    small = _masks(4, (4, 18, 10), p=0.5)
    prompts_t, prompts_j = [], []
    for i in range(5):
        seg = _masks(10 + i, (36, 20), p=0.5).astype(np.uint8)
        prompts_t.append(tengine.PromptMask(i, i % 4, seg))
        prompts_j.append(jengine.PromptMask(i, i % 4, seg))
    ref = jengine._batched_dedup_ious(small, prompts_j, (18, 10))
    out = tengine._batched_dedup_ious(torch.from_numpy(small), prompts_t,
                                      (18, 10))
    np.testing.assert_allclose(out, ref, atol=1e-6)
