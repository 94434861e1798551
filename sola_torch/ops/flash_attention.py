"""Fused (flash) attention with a backward: hand-written CUDA kernels for
Hopper.

Counterpart of ``sola_tpu/ops/flash_attention.py`` (``fused_attention``,
``fused_attention_lse``). Three kernels replace the three Pallas kernels:

* ``sola_torch/csrc/flash_attn_fwd.cu`` replaces ``_attn_kernel``:
  blockwise online-softmax ``softmax(QK^T/sqrt(D)) V`` with fp32
  statistics, masked keys scored -1e30, a per-row logsumexp, and training
  dropout on the probabilities;
* ``sola_torch/csrc/flash_attn_bwd.cu`` replaces ``_attn_bwd_dq_kernel``
  and ``_attn_bwd_dkv_kernel``: dQ, and dK/dV, recomputed from the saved
  logsumexp.

Dropout is the JAX package's counter hash (``_keep_mask``): an entry
(batch*head, global query, global key) is kept when splitmix32 of the seed
and those indices falls below ``round((1 - rate) * 2^32)``, and kept
probabilities are scaled by ``1 / (1 - rate)``; the softmax denominator
stays undropped. All three kernels regenerate the same mask from the seed,
so no mask tensor exists. ``fused_attention`` wires them as one
``torch.autograd.Function``.

On a CUDA tensor the wrappers launch the kernels or raise. On a CPU tensor
they run ``attention_reference`` and ``attention_bwd_reference``, the plain
PyTorch versions of the same functions, which the tests hold against the
JAX package and ``chip_smoke.py`` holds the kernels against on the card.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

NEG_INF = -1e30
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_MASK32 = 0xFFFFFFFF

# kernel launches since the last reset (plain integers; chip_smoke.py zeroes
# them before a path and reads them after): the forward, the dQ kernel and
# the dK/dV kernel
launches = 0
bwd_dq_launches = 0
bwd_dkv_launches = 0


# ---------------------------------------------------------------------------
# the dropout hash
# ---------------------------------------------------------------------------

def dropout_consts(rate: float) -> tuple:
    """(keep_thresh, inv_keep) of ``_dropout_consts``: keep an entry whose
    hash is below keep_thresh, and scale it by inv_keep."""
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"dropout rate must be in [0, 1), got {rate}")
    keep = 1.0 - rate
    return min(2 ** 32 - 1, int(round(keep * 2 ** 32))), 1.0 / keep


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for int64 x in [0, 2^32): two 16-bit halves of c, so
    no product leaves int64."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _MASK32


def _fmix32(x: torch.Tensor) -> torch.Tensor:
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def keep_mask_reference(seed: int, bh, lq: int, lk: int,
                        rate: float) -> torch.Tensor:
    """Plain version of the kernels' keep mask: bool (*bh.shape, lq, lk),
    True where (batch*head ``bh``, query q, key k) is kept. ``bh`` is an
    index or a tensor of indices; the hash uses global indices, so the mask
    does not depend on any tiling. The wrapping uint32 arithmetic runs in
    int64 with a 32-bit mask after each multiply."""
    thresh, _ = dropout_consts(rate)
    bh = torch.as_tensor(bh, dtype=torch.int64)
    seed_t = torch.tensor(int(seed) & _MASK32, dtype=torch.int64,
                          device=bh.device)
    base = _fmix32(seed_t ^ _mul32(bh, 0x9E3779B1))[..., None, None]
    rows = _mul32(torch.arange(lq, dtype=torch.int64, device=bh.device),
                  0x85EBCA6B)[:, None]
    cols = _mul32(torch.arange(lk, dtype=torch.int64, device=bh.device),
                  0xC2B2AE35)[None, :]
    return _fmix32(base ^ rows ^ cols) < thresh


def _drop_factor(b, h, lq, lk, rate, seed, device) -> torch.Tensor:
    """keep x inv_keep as fp32 (B, H, Lq, Lk), with bh = b * H + h (the
    JAX package's repeat-and-reshape order)."""
    _, inv_keep = dropout_consts(rate)
    bh = torch.arange(b * h, device=device).reshape(b, h)
    return keep_mask_reference(seed, bh, lq, lk, rate).float() * inv_keep


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def _scores(q, k, key_mask):
    scale = 1.0 / (q.shape[-1] ** 0.5)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if key_mask is not None:
        s = s.masked_fill(~key_mask.bool()[:, None, None, :], NEG_INF)
    return s


def attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        key_mask: Optional[torch.Tensor] = None,
                        dropout_rate: float = 0.0,
                        dropout_seed: Optional[int] = None):
    """Plain PyTorch version of the forward kernel's function: (out, lse).

    q (B, H, Lq, D); k, v (B, H, Lk, D); key_mask (B, Lk) bool or None.
    Scores in fp32; a masked key scores -1e30, so a fully masked row gives
    the mean of V. The unnormalized probabilities (dropped, with a rate > 0
    and a seed) are cast to V's dtype before the PV product and the
    undropped row sum divides afterwards, as in the kernel. Returns out in
    q's dtype and lse (B, H, Lq) fp32."""
    s = _scores(q, k, key_mask)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    if dropout_rate > 0.0:
        b, h, lq, lk = p.shape
        p = p * _drop_factor(b, h, lq, lk, dropout_rate, dropout_seed,
                             p.device)
    acc = torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype).float(), v.float())
    out = (acc / l).to(q.dtype)
    return out, (m + torch.log(l))[..., 0]


def bwd_delta(out: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """delta = rowsum(dO * O) (B, H, Lq) fp32, from the forward's own
    (dropped) output: one torch reduction before the backward kernels."""
    return (do.float() * out.float()).sum(dim=-1).contiguous()


def attention_bwd_reference(q, k, v, key_mask, out, lse, do,
                            dropout_rate: float = 0.0,
                            dropout_seed: Optional[int] = None):
    """Plain PyTorch version of the two backward kernels: (dq, dk, dv) in
    the dtypes of q, k, v, in the formulas of ``_attn_bwd_dq_kernel`` and
    ``_attn_bwd_dkv_kernel``: P = exp(S - lse) from the forward's lse,
    delta = rowsum(dO * O) from its (dropped) output, dP = dO V^T times the
    forward's keep mask x inv_keep, dS = P (dP - delta) / sqrt(D)."""
    scale = 1.0 / (q.shape[-1] ** 0.5)
    p = torch.exp(_scores(q, k, key_mask) - lse[..., None])
    dof = do.float()
    dp = torch.einsum("bhqd,bhkd->bhqk", dof, v.float())
    delta = bwd_delta(out, do)[..., None]
    p_v = p
    if dropout_rate > 0.0:
        b, h, lq, lk = p.shape
        drop = _drop_factor(b, h, lq, lk, dropout_rate, dropout_seed,
                            p.device)
        p_v = p * drop
        dp = dp * drop
    ds = p * (dp - delta) * scale
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, k.float())
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, q.float())
    dv = torch.einsum("bhqk,bhqd->bhkd", p_v, dof)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


# ---------------------------------------------------------------------------
# the kernels
# ---------------------------------------------------------------------------

_PTR, _INT, _U32, _F32 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32,
                          ctypes.c_float)
_DROP_ARGS = [_F32, _U32, _U32, _F32, _PTR]  # scale, seed, thresh, inv, stream


def _library(name: str, fns: dict):
    from sola_torch.ops.kernel_build import load_library
    lib = load_library(name)
    for fn_name, argtypes in fns.items():
        fn = getattr(lib, fn_name)
        if fn.argtypes is None:
            fn.restype = ctypes.c_int
            fn.argtypes = argtypes
    return lib


def _fwd_library():
    return _library("flash_attn_fwd", {
        "sola_flash_attn_fwd": [_PTR] * 6 + [_INT] * 6 + _DROP_ARGS})


def _bwd_library():
    return _library("flash_attn_bwd", {
        "sola_flash_attn_bwd_dq": [_PTR] * 8 + [_INT] * 6 + _DROP_ARGS,
        "sola_flash_attn_bwd_dkv": [_PTR] * 9 + [_INT] * 6 + _DROP_ARGS})


def _check(q, k, v, key_mask, extra=()):
    """Validates the kernels' inputs; returns the key mask as (B, Lk) bytes
    on q's device, or None."""
    b, h, lq, d = q.shape
    lk = k.shape[2]
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"flash kernel takes float32 or bfloat16, got "
                        f"{q.dtype}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("q, k and v must share one dtype")
    if k.shape != (b, h, lk, d) or v.shape != k.shape:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if d % 8 != 0 or d > 256:
        raise ValueError(f"head dim must be a multiple of 8 and <= 256, "
                         f"got {d}")
    for name, t in (("q", q), ("k", k), ("v", v)) + tuple(extra):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    if key_mask is None:
        return None
    if key_mask.shape != (b, lk):
        raise ValueError(f"key_mask must be (B, Lk) = {(b, lk)}, got "
                         f"{tuple(key_mask.shape)}")
    return key_mask.to(device=q.device, dtype=torch.uint8).contiguous()


def _drop_args(q, rate: float, seed: Optional[int]) -> tuple:
    scale = 1.0 / (q.shape[-1] ** 0.5)
    if rate == 0.0:
        return scale, 0, 0, 0.0
    thresh, inv_keep = dropout_consts(rate)
    return scale, int(seed) & _MASK32, thresh, inv_keep


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _launch(q, k, v, key_mask, dropout_rate=0.0, dropout_seed=None):
    """The forward kernel: (out, lse)."""
    global launches
    b, h, lq, d = q.shape
    mask = _check(q, k, v, key_mask)
    out = torch.empty_like(q)
    lse = torch.empty((b, h, lq), device=q.device, dtype=torch.float32)
    lib = _fwd_library()
    with torch.cuda.device(q.device):
        rc = lib.sola_flash_attn_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            mask.data_ptr() if mask is not None else None,
            out.data_ptr(), lse.data_ptr(), b * h, h, lq, k.shape[2], d,
            _DTYPE_CODE[q.dtype],
            *_drop_args(q, dropout_rate, dropout_seed), _stream(q))
    if rc != 0:
        raise RuntimeError(f"flash attention kernel launch failed: "
                           f"cudaError {rc}")
    launches += 1
    return out, lse


def _launch_bwd_kernel(kernel: str, q, k, v, key_mask, do, lse, delta,
                       dropout_rate=0.0, dropout_seed=None) -> tuple:
    """One backward kernel: "dq" gives (dq,) like q, "dkv" gives (dk, dv)
    like k, v."""
    global bwd_dq_launches, bwd_dkv_launches
    b, h, lq, d = q.shape
    mask = _check(q, k, v, key_mask,
                  (("do", do), ("lse", lse), ("delta", delta)))
    if (do.shape != q.shape or do.dtype != q.dtype
            or lse.shape != (b, h, lq) or delta.shape != (b, h, lq)):
        raise ValueError(f"do {tuple(do.shape)} {do.dtype}, lse "
                         f"{tuple(lse.shape)}, delta {tuple(delta.shape)} do "
                         f"not match q {tuple(q.shape)} {q.dtype}")
    grads = tuple(torch.empty_like(t)
                  for t in ((q,) if kernel == "dq" else (k, v)))
    lib = _bwd_library()
    with torch.cuda.device(q.device):
        rc = getattr(lib, f"sola_flash_attn_bwd_{kernel}")(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            mask.data_ptr() if mask is not None else None, do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), *(g.data_ptr() for g in grads),
            b * h, h, lq, k.shape[2], d, _DTYPE_CODE[q.dtype],
            *_drop_args(q, dropout_rate, dropout_seed), _stream(q))
    if rc != 0:
        raise RuntimeError(f"flash attention {kernel} kernel launch failed: "
                           f"cudaError {rc}")
    if kernel == "dq":
        bwd_dq_launches += 1
    else:
        bwd_dkv_launches += 1
    return grads


def _launch_bwd(q, k, v, key_mask, out, lse, do, dropout_rate=0.0,
                dropout_seed=None):
    """delta, then the dQ and dK/dV kernels: (dq, dk, dv)."""
    do = do.to(q.dtype).contiguous()
    delta = bwd_delta(out, do)
    args = (q, k, v, key_mask, do, lse, delta, dropout_rate, dropout_seed)
    return _launch_bwd_kernel("dq", *args) + _launch_bwd_kernel("dkv", *args)


def flash_forward(q, k, v, key_mask=None, dropout_rate=0.0,
                  dropout_seed=None):
    """(out, lse): the forward kernel on a CUDA tensor, its plain version on
    a CPU tensor."""
    if q.is_cuda:
        return _launch(q, k, v, key_mask, dropout_rate, dropout_seed)
    return attention_reference(q, k, v, key_mask, dropout_rate,
                               dropout_seed)


def flash_backward(q, k, v, key_mask, out, lse, do, dropout_rate=0.0,
                   dropout_seed=None):
    """(dq, dk, dv): the dQ and dK/dV kernels on a CUDA tensor, their plain
    version on a CPU tensor."""
    if q.is_cuda:
        return _launch_bwd(q, k, v, key_mask, out, lse, do, dropout_rate,
                           dropout_seed)
    return attention_bwd_reference(q, k, v, key_mask, out, lse, do,
                                   dropout_rate, dropout_seed)


class FlashAttention(torch.autograd.Function):
    """Fused attention whose forward is the forward kernel and whose
    backward is the dQ and dK/dV kernels (plain versions on the CPU). The
    key mask and the dropout seed get no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, key_mask, dropout_rate, dropout_seed):
        q, k, v = (t.contiguous() for t in (q, k, v))
        out, lse = flash_forward(q, k, v, key_mask, dropout_rate,
                                 dropout_seed)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.key_mask = key_mask
        ctx.dropout = (dropout_rate, dropout_seed)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_backward(q, k, v, ctx.key_mask, out, lse, do,
                                    *ctx.dropout)
        return dq, dk, dv, None, None, None


def fused_attention_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        key_mask: Optional[torch.Tensor] = None,
                        block_q: int = 128, block_k: int = 128):
    """Forward attention that also returns the per-row logsumexp:
    (out (B, H, Lq, D), lse (B, H, Lq) fp32).

    ``block_q``/``block_k`` keep the JAX signature; the CUDA kernel's tiles
    are fixed by the kernel and the values are not used."""
    del block_q, block_k
    return flash_forward(q, k, v, key_mask)


def fused_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    key_mask: Optional[torch.Tensor] = None,
                    block_q: int = 128, block_k: int = 128,
                    dropout_rate: float = 0.0,
                    dropout_seed: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
    """Fused attention over (B, H, Lq, D) / (B, H, Lk, D) head tensors with
    an optional (B, Lk) key-validity mask. Returns (B, H, Lq, D), with a
    gradient through the backward kernels.

    ``dropout_rate`` > 0 drops attention probabilities in the kernels with
    the counter hash of ``dropout_seed``, a (1,) integer tensor (vary it per
    call). ``block_q``/``block_k`` keep the JAX signature and are not
    used."""
    del block_q, block_k
    seed = None
    if dropout_rate > 0.0:
        if dropout_seed is None:
            raise ValueError("dropout_rate > 0 requires dropout_seed")
        seed = int(dropout_seed.reshape(-1)[0]) & _MASK32
    return FlashAttention.apply(q, k, v, key_mask, float(dropout_rate), seed)
