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
    before = (tfa.launches, tfa.bwd_launches)
    _torch_grads(q, k, v, cot, None, 0.1, 3)
    assert (tfa.launches, tfa.bwd_launches) == before


# ---------------------------------------------------------------------------
# the fused backward kernel's work split, walked on the CPU
# ---------------------------------------------------------------------------

EMULATION_ATOL = 1e-5  # fp32 on both sides; only the order of sums differs


def _emulate_fused_backward(q, k, v, key_mask, out, lse, do, rate, seed):
    """The loops of csrc/flash_attn_bwd.cu in torch, fp32, at its index
    maps: blocks of G packed heads (``bwd_plan``), the batch entry's key
    list in ascending order (every key when none is valid), chunks of KH
    slots per head with dQ carried in a workspace across chunks, query
    tiles of RH rows per head with rows past Lq zero-filled (lse +inf),
    products only inside each head's diagonal block, and the hash on the
    original key index. Outputs start as NaN, so a slot the walk does not
    write shows."""
    b, h, lq, d = q.shape
    lk = k.shape[2]
    g_n, rh, kh = tfa.bwd_plan(h, lq, lk, d)
    scale = 1.0 / d ** 0.5
    n = b * h
    qf, dof = (t.reshape(n, lq, d).float() for t in (q, do))
    kf, vf = (t.reshape(n, lk, d).float() for t in (k, v))
    lse_f = lse.reshape(n, lq)
    delta = tfa.bwd_delta(out, do).reshape(n, lq)
    dq, dk, dv = (torch.full((n, m, d), float("nan")) for m in (lq, lk, lk))
    inv_keep = tfa.dropout_consts(rate)[1] if rate else 1.0
    for bh0 in range(0, n, g_n):
        row = None if key_mask is None else key_mask[bh0 // h].bool()
        all_masked = row is not None and not row.any()
        listed = None if all_masked else row
        keys_all = (torch.arange(lk) if listed is None
                    else listed.nonzero()[:, 0])
        if listed is not None:  # masked keys: zero rows, not computed
            dk[bh0:bh0 + g_n, ~listed] = 0.0
            dv[bh0:bh0 + g_n, ~listed] = 0.0
        chunks = [keys_all[i:i + kh] for i in range(0, len(keys_all), kh)]
        ws = torch.full((g_n, lq, d), float("nan"))
        for ci, keys in enumerate(chunks):
            nvc = len(keys)
            s_k, s_v = (torch.zeros(g_n * kh, d) for _ in range(2))
            for g in range(g_n):
                s_k[g * kh:g * kh + nvc] = kf[bh0 + g, keys]
                s_v[g * kh:g * kh + nvc] = vf[bh0 + g, keys]
            dk_acc, dv_acc = torch.zeros(g_n * kh, d), torch.zeros(g_n * kh, d)
            for q0 in range(0, lq, rh):
                qv = min(rh, lq - q0)
                rows4 = -(-qv // 4) * 4  # micro-tiles of 4 rows
                s_q, s_do = torch.zeros(g_n * rh, d), torch.zeros(g_n * rh, d)
                s_lse = torch.full((g_n * rh,), float("inf"))
                s_delta = torch.zeros(g_n * rh)
                for g in range(g_n):
                    r = slice(g * rh, g * rh + qv)
                    s_q[r] = qf[bh0 + g, q0:q0 + qv]
                    s_do[r] = dof[bh0 + g, q0:q0 + qv]
                    s_lse[r] = lse_f[bh0 + g, q0:q0 + qv]
                    s_delta[r] = delta[bh0 + g, q0:q0 + qv]
                p_t = torch.full((g_n * kh, g_n * rh), float("nan"))
                ds_t = torch.full((g_n * kh, g_n * rh), float("nan"))
                for g in range(g_n):
                    r = slice(g * rh, g * rh + rows4)
                    c = slice(g * kh, g * kh + nvc)
                    s = s_q[r] @ s_k[c].T
                    dp = s_do[r] @ s_v[c].T
                    score = (torch.full_like(s, tfa.NEG_INF) if all_masked
                             else s * scale)
                    p = torch.exp(score - s_lse[r, None])
                    pv = p
                    if rate:
                        keep = tfa.keep_mask_reference(
                            seed, bh0 + g, q0 + rows4, lk, rate)
                        f = keep[q0:q0 + rows4][:, keys].float() * inv_keep
                        pv, dp = p * f, dp * f
                    p_t[c, r] = pv.T
                    ds_t[c, r] = (p * (dp - s_delta[r, None]) * scale).T
                for g in range(g_n):
                    r = slice(g * rh, g * rh + rows4)
                    c = slice(g * kh, g * kh + nvc)
                    dv_acc[c] += p_t[c, r] @ s_do[r]
                    dk_acc[c] += ds_t[c, r] @ s_q[r]
                    part = ds_t[c, g * rh:g * rh + qv].T @ s_k[c]
                    if len(chunks) == 1:
                        dq[bh0 + g, q0:q0 + qv] = part
                        continue
                    acc = part if ci == 0 else ws[g, q0:q0 + qv] + part
                    ws[g, q0:q0 + qv] = acc
                    if ci == len(chunks) - 1:
                        dq[bh0 + g, q0:q0 + qv] = acc
            for g in range(g_n):
                dk[bh0 + g, keys] = dk_acc[g * kh:g * kh + nvc]
                dv[bh0 + g, keys] = dv_acc[g * kh:g * kh + nvc]
    return tuple(t.reshape(b, h, -1, d) for t in (dq, dk, dv))


def _frames_mask(b, lk, lengths):
    return torch.arange(lk)[None] < torch.tensor(lengths)[:, None]


# (name, b, h, lq, lk, d, mask, plan the case must take)
FUSED_CASES = [
    ("obj_like", 2, 2, 16, 16, 16,
     lambda: _frames_mask(2, 16, [10, 10]), (2, 16, 16)),
    ("motion_like_packed", 3, 8, 8, 8, 16,
     lambda: _frames_mask(3, 8, [3, 8, 5]), (8, 8, 8)),
    ("object2lang_like", 2, 2, 40, 24, 16,
     lambda: torch.ones(2, 24, dtype=torch.bool).index_fill_(
         1, torch.arange(6, 16), False), (1, 64, 64)),
    ("several_chunks", 1, 2, 70, 150, 16,
     lambda: torch.ones(1, 150, dtype=torch.bool), (1, 64, 64)),
    ("no_valid_key", 2, 2, 16, 16, 16,
     lambda: _frames_mask(2, 16, [0, 9]), (2, 16, 16)),
    ("no_mask_several_chunks", 1, 2, 20, 70, 16, lambda: None, (1, 64, 64)),
]


@pytest.mark.parametrize("rate", [0.0, 0.25])
@pytest.mark.parametrize("case", FUSED_CASES, ids=[c[0] for c in FUSED_CASES])
def test_fused_work_split_matches_plain_backward(case, rate):
    name, b, h, lq, lk, d, make_mask, plan = case
    assert tfa.bwd_plan(h, lq, lk, d) == plan
    q, k, v, do = (torch.from_numpy(x)
                   for x in _inputs(len(name), b, h, lq, lk, d))
    mask = make_mask()
    seed = 0x2545F491
    out, lse = tfa.attention_reference(q, k, v, mask, rate, seed)
    got = _emulate_fused_backward(q, k, v, mask, out, lse, do, rate, seed)
    want = tfa.attention_bwd_reference(q, k, v, mask, out, lse, do, rate,
                                       seed)
    for g, w, n in zip(got, want, ("dq", "dk", "dv")):
        np.testing.assert_allclose(g.numpy(), w.numpy(),
                                   atol=EMULATION_ATOL, rtol=0, err_msg=n)
    if mask is not None:  # masked keys of an entry with a valid key: 0
        zero = (~mask & mask.any(dim=1, keepdim=True))[:, None, :, None]
        for g in got[1:]:
            assert (g[zero.expand_as(k)] == 0).all()


def test_bwd_plan_at_the_selection_sites():
    """obj_attn and object2lang_attn take one 64-slot chunk of one head;
    motion_attn packs its 8 heads of 8 x 8; D 256 halves the chunk."""
    assert tfa.bwd_plan(8, 64, 64, 128) == (1, 64, 64)
    assert tfa.bwd_plan(8, 8, 8, 128) == (8, 8, 8)
    assert tfa.bwd_plan(8, 512, 128, 128) == (1, 64, 64)
    assert tfa.bwd_plan(8, 70, 90, 256) == (1, 64, 32)
    assert tfa.bwd_plan(8, 8, 8, 256) == (4, 8, 8)
    assert tfa.bwd_plan(6, 5, 3, 64) == (6, 8, 8)
