"""Seeded random weights of SAM2 hiera-L, made on the card.

The parameter names and shapes come from the plain reference's model at the
configuration's sizes, built on the meta device; the values come from one
``torch.Generator`` on the card in one normal draw, split and scaled per
tensor: linear and conv weights N(0, 1/fan_in), biases 0, layer norms 1 and
0, token embeddings N(0, 1), position and memory parameters N(0, 0.02),
layer scales 1e-6, the prompt encoder's Fourier matrix N(0, its scale).
The configuration's ``assumed`` ``obj_score_bias`` is the bias of the
object-score head's last layer: with it every frame holds an object, so the
tracked masks and object pointers carry the model's output and not the
fixed no-object pointer. Weights are returned in bf16, the type the port
serves them in (its image encoder computes in fp32 on those values).
"""

from __future__ import annotations

import math

import torch
from torch import nn

OBJ_SCORE_BIAS = "sam_mask_decoder.pred_obj_score_head.layers.2.bias"
_SMALL = ("pos_embed", "pos_embed_window", "no_mem_embed",
          "maskmem_tpos_enc", "no_obj_ptr")


def sam2_config(size: str = "large"):
    from benchmark.reference.sam2.model import SAM2Config
    return SAM2Config.large() if size == "large" else SAM2Config.tiny_test()


def _specs(model) -> list:
    """(name, shape, std or None, constant) per tensor of the state dict."""
    from benchmark.reference.sam2.common import LayerNorm2d
    from benchmark.reference.sam2.common import RandomPositionEncoding
    owner = {}
    for mname, mod in model.named_modules():
        for pname, _ in list(mod.named_parameters(recurse=False)) + list(
                mod.named_buffers(recurse=False)):
            owner[f"{mname}.{pname}" if mname else pname] = (mod, pname)
    specs = []
    for name, t in model.state_dict().items():
        mod, leaf = owner[name]
        shape = tuple(t.shape)
        if isinstance(mod, (nn.Linear, nn.Conv2d, nn.ConvTranspose2d)):
            if leaf == "weight":
                fan_in = (shape[0] if isinstance(mod, nn.ConvTranspose2d)
                          else shape[1]) * math.prod(shape[2:])
                specs.append((name, shape, fan_in ** -0.5, 0.0))
            else:
                specs.append((name, shape, None, 0.0))
        elif isinstance(mod, (nn.LayerNorm, LayerNorm2d)):
            specs.append((name, shape, None, 1.0 if leaf == "weight" else 0.0))
        elif isinstance(mod, nn.Embedding):
            specs.append((name, shape, 1.0, 0.0))
        elif isinstance(mod, RandomPositionEncoding):
            specs.append((name, shape, mod.scale, 0.0))
        elif leaf in _SMALL:
            specs.append((name, shape, 0.02, 0.0))
        elif leaf == "gamma":
            specs.append((name, shape, None, 1e-6))
        else:
            raise KeyError(f"no init rule for {name}")
    return specs


@torch.no_grad()
def state_dict(config: dict, seed: int, device="cuda",
               size: str = "large") -> dict:
    """The weights of ``config`` (``configs/sam2_hiera_l.json``) drawn from
    ``seed`` on ``device``, in bf16."""
    from benchmark.reference.sam2.model import SAM2Model
    with torch.device("meta"):
        model = SAM2Model(sam2_config(size))
    specs = _specs(model)
    n = sum(math.prod(s) for _, s, std, _ in specs if std is not None)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    draw = torch.randn(n, generator=gen, device=device, dtype=torch.float32)
    out, off = {}, 0
    for name, shape, std, const in specs:
        if std is None:
            t = torch.full(shape, const, device=device, dtype=torch.float32)
        else:
            k = math.prod(shape)
            t = (draw[off:off + k] * std).reshape(shape)
            off += k
        out[name] = t.to(torch.bfloat16)
    out[OBJ_SCORE_BIAS].fill_(float(config["assumed"]["obj_score_bias"]))
    return out
