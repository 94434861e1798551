"""Multi-scale deformable sampling: a hand-written CUDA kernel for Hopper.

Counterpart of ``sola_tpu/ops/deformable_interp.py``
(``ms_deform_attn_core_pallas``). The kernel lives in
``sola_torch/csrc/ms_deform_attn_fwd.cu`` and replaces the Pallas
``_interp_kernel``: for each level, query and head, the sum over points and
bilinear corners of attn_w * corner_w * V[corner], ``align_corners=False``,
zero outside the map, fp32 accumulation, output in the values' dtype.

On a CUDA tensor ``ms_deform_attn`` launches the kernel or raises. On a CPU
tensor it runs ``trackgen.gdino.deformable.ms_deform_attn_core``, the plain
PyTorch version of the same function, which the tests hold against the JAX
package and ``chip_smoke.py`` holds the kernel against on the card.

The TPU kernel's tile-scheduling switches (``SOLA_DEFORMABLE_CORE``,
``SOLA_DEFORM_QBLK``, ``SOLA_DEFORM_HWBLK``, ``SOLA_DEFORM_GUARDS``) have no
counterpart: the gather kernel has no tiles to choose.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Union

import torch

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_MAX_LEVELS = 16
_MAX_HEAD_DIM = 256

# kernel launches since the last reset (plain integer; chip_smoke.py zeroes
# it before the main path and reads it after)
launches = 0


def _library():
    from sola_torch.ops.kernel_build import load_library
    lib = load_library("ms_deform_attn_fwd")
    fn = lib.sola_ms_deform_attn_fwd
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 8 + [
            ctypes.c_void_p]
    return lib


def flatten_levels(value_levels: Sequence[torch.Tensor]):
    """Per-level (B, H_l, W_l, C) maps -> ((B, sum HW, C), [(H_l, W_l)])."""
    b = value_levels[0].shape[0]
    shapes = [(int(v.shape[1]), int(v.shape[2])) for v in value_levels]
    flat = torch.cat([v.reshape(b, -1, v.shape[-1]) for v in value_levels],
                     dim=1)
    return flat, shapes


def _launch(value: torch.Tensor, shapes: Sequence[tuple],
            loc: torch.Tensor, attn: torch.Tensor) -> torch.Tensor:
    global launches
    b, s, c = value.shape
    _, lq, n_heads, n_levels, n_points, _ = loc.shape
    if value.dtype not in _DTYPE_CODE:
        raise TypeError(f"deformable kernel takes float32 or bfloat16 "
                        f"values, got {value.dtype}")
    if c % n_heads:
        raise ValueError(f"channels {c} not divisible by {n_heads} heads")
    head_dim = c // n_heads
    if head_dim > _MAX_HEAD_DIM or n_levels > _MAX_LEVELS:
        raise ValueError(f"head_dim {head_dim} (max {_MAX_HEAD_DIM}) or "
                         f"levels {n_levels} (max {_MAX_LEVELS}) too large")
    if len(shapes) != n_levels or sum(h * w for h, w in shapes) != s:
        raise ValueError(f"spatial shapes {list(shapes)} do not match "
                         f"{n_levels} levels and {s} value rows")
    if attn.shape != loc.shape[:-1] or loc.shape[0] != b:
        raise ValueError(f"shape mismatch: value {tuple(value.shape)}, "
                         f"locations {tuple(loc.shape)}, weights "
                         f"{tuple(attn.shape)}")
    for name, t in (("locations", loc), ("weights", attn)):
        if t.device != value.device:
            raise ValueError(f"{name} on {t.device}, values on "
                             f"{value.device}")
    value = value.contiguous()
    # location math runs in fp32 whatever the values' type, as in
    # corner_terms (bf16 coordinates would quantize subpixel positions)
    loc = loc.to(torch.float32).contiguous()
    attn = attn.to(torch.float32).contiguous()
    out = torch.empty((b, lq, c), device=value.device, dtype=value.dtype)
    dims = (ctypes.c_int * (2 * n_levels))(*[d for hw in shapes for d in hw])
    starts, acc = [], 0
    for h, w in shapes:
        starts.append(acc)
        acc += h * w
    starts = (ctypes.c_int * n_levels)(*starts)
    lib = _library()
    with torch.cuda.device(value.device):
        stream = torch.cuda.current_stream(value.device).cuda_stream
        rc = lib.sola_ms_deform_attn_fwd(
            value.data_ptr(), loc.data_ptr(), attn.data_ptr(),
            ctypes.addressof(dims), ctypes.addressof(starts), out.data_ptr(),
            b, s, lq, n_heads, head_dim, n_levels, n_points,
            _DTYPE_CODE[value.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"deformable sampling kernel launch failed: "
                           f"cudaError {rc}")
    launches += 1
    return out


def ms_deform_attn(value_levels: Union[Sequence[torch.Tensor], torch.Tensor],
                   sampling_locations: torch.Tensor,
                   attention_weights: torch.Tensor,
                   spatial_shapes: Optional[Sequence[tuple]] = None
                   ) -> torch.Tensor:
    """Deformable sampling, the contract of ``ms_deform_attn_core_pallas``.

    value_levels: per-level (B, H_l, W_l, n_heads * head_dim), or the
      flattened (B, sum HW, C) tensor with ``spatial_shapes`` [(H_l, W_l)]
      in order (each level's rows start where the previous level's end)
    sampling_locations: (B, Lq, n_heads, n_levels, n_points, 2) in [0, 1]
    attention_weights:  (B, Lq, n_heads, n_levels, n_points)
    Returns (B, Lq, n_heads * head_dim) in the values' dtype."""
    if spatial_shapes is None:
        value, shapes = flatten_levels(value_levels)
    else:
        value, shapes = value_levels, [tuple(int(d) for d in hw)
                                       for hw in spatial_shapes]
    if value.is_cuda:
        return _launch(value, shapes, sampling_locations, attention_weights)
    from sola_torch.trackgen.gdino.deformable import ms_deform_attn_core
    return ms_deform_attn_core(value, sampling_locations, attention_weights,
                               shapes)
