"""The port's fused attention with dropout and its backward (on the CPU: the
plain PyTorch versions of the CUDA kernels' functions) against the JAX
package's Pallas kernels in interpret mode: the keep mask bit for bit, the
forward with dropout, and dQ/dK/dV through ``jax.grad`` of the JAX
``fused_attention`` (its custom_vjp, i.e. the Pallas backward kernels).
The kernels themselves run only on the card; chip_smoke.py holds them
against these plain versions there."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sola_tpu.ops import flash_attention as jfa
from sola_torch.ops import flash_attention as tfa
from tests.test_flash_attention import np_keep_mask

FWD_ATOL = 2e-5
GRAD_ATOL = 1e-4


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


def _inputs(seed, b, h, lq, lk, d):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(shape, dtype=np.float32)
                 for shape in ((b, h, lq, d), (b, h, lk, d), (b, h, lk, d),
                               (b, h, lq, d)))


def _jax_grads(q, k, v, cot, mask, rate, seed, block):
    def loss(q, k, v):
        out = jfa.fused_attention(
            q, k, v, key_mask=None if mask is None else jnp.asarray(mask),
            block_q=block, block_k=block, dropout_rate=rate,
            dropout_seed=None if rate == 0.0 else jnp.asarray([seed],
                                                              jnp.uint32))
        return jnp.sum(out * cot), out
    (_, out), grads = jax.value_and_grad(loss, argnums=(0, 1, 2),
                                         has_aux=True)(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return np.asarray(out), [np.asarray(g) for g in grads]


def _torch_grads(q, k, v, cot, mask, rate, seed):
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = tfa.fused_attention(
        tq, tk, tv, None if mask is None else torch.from_numpy(mask),
        dropout_rate=rate,
        dropout_seed=None if rate == 0.0 else torch.tensor([seed]))
    (out * torch.from_numpy(cot)).sum().backward()
    return out.detach().numpy(), [t.grad.numpy() for t in (tq, tk, tv)]


@pytest.mark.parametrize("seed,bh,lq,lk,rate", [
    (12345, 0, 24, 40, 0.3), (777, 5, 64, 64, 0.1), (0, 4095, 8, 8, 0.1),
    (2 ** 32 - 1, 63, 512, 128, 0.1), (42, 3, 33, 17, 0.5)])
def test_keep_mask_matches_numpy_bit_for_bit(seed, bh, lq, lk, rate):
    got = tfa.keep_mask_reference(seed, bh, lq, lk, rate).numpy()
    np.testing.assert_array_equal(got, np_keep_mask(seed, bh, lq, lk, rate))
    # a tensor of batch*head indices gives each one's mask
    many = tfa.keep_mask_reference(seed, [bh, bh + 1], lq, lk, rate).numpy()
    np.testing.assert_array_equal(many[1],
                                  np_keep_mask(seed, bh + 1, lq, lk, rate))


def test_dropout_consts_match_the_jax_package():
    for rate in (0.1, 0.2, 0.25, 0.5, 1e-12):
        assert tfa.dropout_consts(rate) == jfa._dropout_consts(rate)
    with pytest.raises(ValueError):
        tfa.dropout_consts(1.0)


@pytest.mark.parametrize("masked", [False, True])
def test_forward_with_dropout_matches_pallas(masked):
    b, h, lq, lk, d = 2, 2, 24, 40, 32
    q, k, v, _ = _inputs(1, b, h, lq, lk, d)
    mask = None
    if masked:
        mask = np.ones((b, lk), bool)
        mask[0, 25:] = False
        mask[1, 5:9] = False
    rate, seed = 0.3, 12345
    ref = jfa.fused_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        key_mask=None if mask is None else jnp.asarray(mask), block_q=16,
        block_k=16, dropout_rate=rate,
        dropout_seed=jnp.asarray([seed], jnp.uint32))
    out = tfa.fused_attention(
        *(torch.from_numpy(x) for x in (q, k, v)),
        None if mask is None else torch.from_numpy(mask), dropout_rate=rate,
        dropout_seed=torch.tensor([seed]))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=FWD_ATOL)
    # and dropout is live: the undropped output differs
    plain = tfa.fused_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                                None if mask is None else
                                torch.from_numpy(mask))
    assert np.abs(plain.numpy() - out.numpy()).max() > 1e-3


# (name, b, h, lq, lk, d, mask kind, rate, jax block)
GRAD_CASES = [
    ("unmasked", 2, 2, 24, 40, 32, None, 0.0, 16),
    ("masked", 2, 2, 24, 40, 32, "holes", 0.0, 16),
    ("nonaligned", 1, 2, 21, 37, 16, None, 0.0, 16),
    ("dropout", 2, 2, 24, 40, 32, None, 0.25, 16),
    ("dropout_masked", 2, 2, 24, 40, 32, "tail", 0.25, 16),
    ("d128_dropout_masked", 2, 2, 20, 24, 128, "holes", 0.1, 8),
]


@pytest.mark.parametrize("case", GRAD_CASES, ids=[c[0] for c in GRAD_CASES])
def test_gradients_match_pallas_backward(case):
    name, b, h, lq, lk, d, kind, rate, block = case
    q, k, v, cot = _inputs(len(name), b, h, lq, lk, d)
    mask = None
    if kind == "holes":
        mask = np.ones((b, lk), bool)
        mask[0, lk - 8:] = False
        mask[1, 5:9] = False
    elif kind == "tail":
        mask = np.ones((b, lk), bool)
        mask[1, 30:] = False
    seed = 777
    ref_out, ref = _jax_grads(q, k, v, cot, mask, rate, seed, block)
    out, got = _torch_grads(q, k, v, cot, mask, rate, seed)
    np.testing.assert_allclose(out, ref_out, atol=FWD_ATOL)
    for g, r, n in zip(got, ref, "qkv"):
        np.testing.assert_allclose(g, r, atol=GRAD_ATOL, err_msg=f"d{n}")


def test_masked_key_gradients_are_exactly_zero():
    b, h, lq, lk, d = 2, 2, 24, 40, 32
    q, k, v, cot = _inputs(3, b, h, lq, lk, d)
    mask = np.ones((b, lk), bool)
    mask[0, 25:] = False
    mask[1, 5:9] = False
    for rate in (0.0, 0.3):
        _, (_, dk, dv) = _torch_grads(q, k, v, cot, mask, rate, 99)
        assert np.abs(dk[0, :, 25:]).max() == 0.0
        assert np.abs(dv[1, :, 5:9]).max() == 0.0
        assert np.abs(dv[0, :, :25]).max() > 0.0


def test_dropped_entries_carry_no_value_gradient():
    """With one query row, dV of key j is P_dropped[j] * dO: exactly zero
    where the hash drops (0, j)."""
    b, h, lq, lk, d = 1, 1, 1, 64, 16
    q, k, v, cot = _inputs(4, b, h, lq, lk, d)
    rate, seed = 0.5, 31
    _, (_, _, dv) = _torch_grads(q, k, v, cot, None, rate, seed)
    keep = np_keep_mask(seed, 0, lq, lk, rate)[0]
    assert (~keep).any() and keep.any()
    assert np.abs(dv[0, 0, ~keep]).max() == 0.0
    assert np.abs(dv[0, 0, keep]).min() > 0.0


def test_bwd_reference_formulas_match_dense_autograd():
    """The plain backward equals autograd through the plain forward where
    no row is fully masked (bf16 excluded: autograd would differentiate the
    cast of P)."""
    b, h, lq, lk, d = 2, 2, 12, 20, 16
    q, k, v, cot = _inputs(5, b, h, lq, lk, d)
    mask = torch.ones(b, lk, dtype=torch.bool)
    mask[0, 15:] = False
    tq, tk, tv = (torch.from_numpy(x).double().float().requires_grad_()
                  for x in (q, k, v))
    out, lse = tfa.attention_reference(tq, tk, tv, mask, 0.2, 5)
    (out * torch.from_numpy(cot)).sum().backward()
    dq, dk, dv = tfa.attention_bwd_reference(
        tq.detach(), tk.detach(), tv.detach(), mask, out.detach(),
        lse.detach(), torch.from_numpy(cot), 0.2, 5)
    for g, r in zip((dq, dk, dv), (tq.grad, tk.grad, tv.grad)):
        np.testing.assert_allclose(g.numpy(), r.numpy(), atol=1e-5)


def test_cpu_path_counts_no_launch():
    q, k, v, cot = _inputs(6, 1, 1, 8, 8, 8)
    before = (tfa.launches, tfa.bwd_dq_launches, tfa.bwd_dkv_launches)
    _torch_grads(q, k, v, cot, None, 0.1, 3)
    assert (tfa.launches, tfa.bwd_dq_launches,
            tfa.bwd_dkv_launches) == before
