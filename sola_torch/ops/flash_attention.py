"""Fused (flash) attention forward: a hand-written CUDA kernel for Hopper.

Counterpart of ``sola_tpu/ops/flash_attention.py`` (``fused_attention``,
``fused_attention_lse``). The kernel lives in
``sola_torch/csrc/flash_attn_fwd.cu`` and replaces the Pallas
``_attn_kernel``: blockwise online-softmax ``softmax(QK^T/sqrt(D)) V`` with
fp32 statistics, masked keys scored -1e30, and a per-row logsumexp.

On a CUDA tensor the wrappers launch the kernel or raise. On a CPU tensor
they run ``attention_reference``, the plain PyTorch version of the same
function, which the tests hold against the JAX package and ``chip_smoke.py``
holds the kernel against on the card.

Dropout is not ported yet: ``dropout_rate > 0`` raises.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

NEG_INF = -1e30
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

# kernel launches since the last reset (plain integer; chip_smoke.py zeroes
# it before the main path and reads it after)
launches = 0


def attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        key_mask: Optional[torch.Tensor] = None):
    """Plain PyTorch version of the kernel's function: (out, lse).

    q (B, H, Lq, D); k, v (B, H, Lk, D); key_mask (B, Lk) bool or None.
    Scores in fp32; a masked key scores -1e30, so a fully masked row gives
    the mean of V. The unnormalized probabilities are cast to V's dtype
    before the PV product and the row sum divides afterwards, as in the
    kernel. Returns out in q's dtype and lse (B, H, Lq) fp32."""
    scale = 1.0 / (q.shape[-1] ** 0.5)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if key_mask is not None:
        s = s.masked_fill(~key_mask.bool()[:, None, None, :], NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    acc = torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype).float(), v.float())
    out = (acc / l).to(q.dtype)
    return out, (m + torch.log(l))[..., 0]


def _library():
    from sola_torch.ops.kernel_build import load_library
    lib = load_library("flash_attn_fwd")
    fn = lib.sola_flash_attn_fwd
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [
            ctypes.c_float, ctypes.c_void_p]
    return lib


def _launch(q, k, v, key_mask):
    global launches
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
    mask = None
    if key_mask is not None:
        if key_mask.shape != (b, lk):
            raise ValueError(f"key_mask must be (B, Lk) = {(b, lk)}, got "
                             f"{tuple(key_mask.shape)}")
        mask = key_mask.to(device=q.device, dtype=torch.uint8).contiguous()
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    out = torch.empty_like(q)
    lse = torch.empty((b, h, lq), device=q.device, dtype=torch.float32)
    lib = _library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.sola_flash_attn_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            mask.data_ptr() if mask is not None else None,
            out.data_ptr(), lse.data_ptr(), b * h, h, lq, lk, d,
            _DTYPE_CODE[q.dtype], 1.0 / (d ** 0.5), stream)
    if rc != 0:
        raise RuntimeError(f"flash attention kernel launch failed: "
                           f"cudaError {rc}")
    launches += 1
    return out, lse


def fused_attention_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        key_mask: Optional[torch.Tensor] = None,
                        block_q: int = 128, block_k: int = 128):
    """Forward attention that also returns the per-row logsumexp:
    (out (B, H, Lq, D), lse (B, H, Lq) fp32).

    ``block_q``/``block_k`` keep the JAX signature; the CUDA kernel's tiles
    are fixed by the kernel and the values are not used."""
    del block_q, block_k
    if q.is_cuda:
        return _launch(q, k, v, key_mask)
    return attention_reference(q, k, v, key_mask)


def fused_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    key_mask: Optional[torch.Tensor] = None,
                    block_q: int = 128, block_k: int = 128,
                    dropout_rate: float = 0.0,
                    dropout_seed: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
    """Fused attention over (B, H, Lq, D) / (B, H, Lk, D) head tensors with
    an optional (B, Lk) key-validity mask. Returns (B, H, Lq, D)."""
    del dropout_seed
    if dropout_rate > 0.0:
        raise NotImplementedError(
            "attention dropout comes with the backward kernels")
    return fused_attention_lse(q, k, v, key_mask, block_q, block_k)[0]
