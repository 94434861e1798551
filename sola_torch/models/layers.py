"""Building-block layers for the selection model.

Counterpart of ``sola_tpu/models/layers.py``: weight-standardized Conv1d
(module/ws.py:4-22) and Linear (:24-38) kernels, a mask-aware GroupNorm
(torch ``nn.GroupNorm`` semantics with an optional length mask), the
reference's LeakyReLU, and the prefix-mask helpers of the padded batches.

Public functions keep the JAX package's feature-last (B, L, C) layout; the
convolution runs in torch's (B, C, L) inside. Weights are stored in the
reference checkpoint's torch layouts: Conv1d (out, in, k), Linear
(out, in), GroupNorm ``weight``/``bias``.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn


def _standardize(flat: torch.Tensor) -> torch.Tensor:
    """Per output row: subtract the mean, divide by the Bessel-corrected
    std + 1e-5 (torch ``Tensor.std``'s default)."""
    centered = flat - flat.mean(dim=1, keepdim=True)
    n = flat.shape[1]
    var = (centered * centered).sum(dim=1, keepdim=True) / max(n - 1, 1)
    return centered / (torch.sqrt(var) + 1e-5)


def standardize_conv_kernel(weight: torch.Tensor) -> torch.Tensor:
    """Weight-standardize a Conv1d weight (out, in, k) over its (in, k)
    fan-in per output channel (module/ws.py:8-13)."""
    return _standardize(weight.reshape(weight.shape[0], -1)).reshape(
        weight.shape)


def standardize_dense_kernel(weight: torch.Tensor) -> torch.Tensor:
    """Weight-standardize a Linear weight (out, in) per output row
    (module/ws.py:28-33)."""
    return _standardize(weight)


class WSConv1d(nn.Module):
    """1-D convolution with on-the-fly weight standardization over (B, L, C)
    inputs (ws.Conv1d)."""

    def __init__(self, in_features: int, features: int, kernel_size: int,
                 stride: int = 1, padding: int = 0):
        super().__init__()
        self.stride = stride
        self.padding = padding
        self.weight = nn.Parameter(torch.empty(features, in_features,
                                               kernel_size))
        self.bias = nn.Parameter(torch.empty(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # bf16-transferred tokens upcast to the weights' dtype here
        y = F.conv1d(x.to(self.weight.dtype).transpose(1, 2),
                     standardize_conv_kernel(self.weight), self.bias,
                     stride=self.stride, padding=self.padding)
        return y.transpose(1, 2)


class MaskedGroupNorm(nn.Module):
    """GroupNorm over (B, L, C) with an optional (B, L) validity mask.

    With a full mask this is ``nn.GroupNorm(G, C)`` on the (B, C, L)
    permutation the reference uses: per (sample, group) statistics over
    (C/G, L), biased variance, eps 1e-5, per-channel affine. Masked
    positions are left out of the statistics and come out zero."""

    def __init__(self, num_groups: int, num_channels: int,
                 epsilon: float = 1e-5):
        super().__init__()
        if num_channels % num_groups:
            raise ValueError(f"channels {num_channels} not divisible by "
                             f"groups {num_groups}")
        self.num_groups = num_groups
        self.epsilon = epsilon
        self.weight = nn.Parameter(torch.ones(num_channels))
        self.bias = nn.Parameter(torch.zeros(num_channels))

    def forward(self, x: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        b, l, c = x.shape
        g = self.num_groups
        xg = x.reshape(b, l, g, c // g)
        if mask is None:
            mean = xg.mean(dim=(1, 3), keepdim=True)
            var = (xg - mean).square().mean(dim=(1, 3), keepdim=True)
        else:
            m = mask.to(x.dtype).reshape(b, l, 1, 1)
            count = (m.sum(dim=1, keepdim=True) * (c // g)).clamp_min(1.0)
            mean = (xg * m).sum(dim=(1, 3), keepdim=True) / count
            var = ((xg - mean).square() * m).sum(dim=(1, 3),
                                                 keepdim=True) / count
        y = (xg - mean) * torch.rsqrt(var + self.epsilon)
        y = y.reshape(b, l, c) * self.weight + self.bias
        if mask is not None:
            y = y * mask.to(x.dtype)[..., None]
        return y


def leaky_relu(x: torch.Tensor, negative_slope: float = 0.01) -> torch.Tensor:
    """torch nn.LeakyReLU default slope (module/module.py:77)."""
    return torch.where(x >= 0, x, x * negative_slope)


def prefix_mask(lengths: torch.Tensor, max_len: int) -> torch.Tensor:
    """(B,) valid lengths -> (B, max_len) boolean prefix mask."""
    iota = torch.arange(max_len, device=lengths.device)
    return iota[None, :] < lengths[:, None]


def downsampled_length(lengths: torch.Tensor, stride: int, kernel: int,
                       padding: int) -> torch.Tensor:
    """Conv output length: floor((L + 2p - k) / s) + 1, element-wise."""
    return torch.div(lengths + 2 * padding - kernel, stride,
                     rounding_mode="floor") + 1


class DropoutRng:
    """The random streams of one training forward, all drawn from one
    explicit host ``torch.Generator``, in this order: one draw seeds a
    generator on the device, whose philox stream gives the dropout masks,
    then one draw a call seeds an attention kernel's dropout hash.

    The draws sit in ``seeds``, an int64 (1 + n,) tensor on the device
    (``draw``), and each kernel call reads its seed from there (``seed``
    returns a view, no host sync); ``device`` is the mask generator,
    seeded ``seeds[0]``. ``fresh`` makes both for an eager forward; a
    captured forward keeps one buffer and one generator and the replaying
    step rewrites and re-seeds them (``train/graphs.py``)."""

    def __init__(self, seeds: torch.Tensor, device: torch.Generator):
        self.seeds = seeds
        self.device = device
        self._calls = 0

    @staticmethod
    def draw(generator: torch.Generator, n_calls: int) -> torch.Tensor:
        """The host int64 (1 + n_calls,) draws of one forward: the mask
        generator's seed in [0, 2^62), then each call's in [0, 2^32)."""
        draws = [torch.randint(0, 2 ** 62, (1,), generator=generator)]
        draws += [torch.randint(0, 2 ** 32, (1,), generator=generator)
                  for _ in range(n_calls)]
        return torch.cat(draws)

    @classmethod
    def fresh(cls, generator: torch.Generator, device,
              n_calls: int) -> "DropoutRng":
        """An eager forward's streams: the draws copied to ``device`` at
        once and a new mask generator there."""
        draws = cls.draw(generator, n_calls)
        mask_gen = torch.Generator(device=device).manual_seed(int(draws[0]))
        return cls(draws.to(device, non_blocking=True), mask_gen)

    def seed(self) -> torch.Tensor:
        """The next kernel call's seed: a (1,) int64 view of ``seeds``."""
        self._calls += 1
        if self._calls >= self.seeds.shape[0]:
            raise RuntimeError(f"a forward drew {self._calls} kernel seeds, "
                               f"{self.seeds.shape[0] - 1} were drawn")
        return self.seeds[self._calls:self._calls + 1]

    def dropout(self, x: torch.Tensor, rate: float) -> torch.Tensor:
        """Keep with probability 1 - rate and scale kept values by
        1 / (1 - rate) (flax ``nn.Dropout``)."""
        keep = 1.0 - rate
        kept = torch.rand(x.shape, generator=self.device,
                          device=x.device) < keep
        return torch.where(kept, x / keep, torch.zeros((), dtype=x.dtype,
                                                       device=x.device))
