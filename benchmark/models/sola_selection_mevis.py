"""Seeded random weights of SOLA's selector and its frozen RoBERTa-large
text encoder, made on the card.

Names and shapes come from the plain reference's modules on the meta
device; the values from one ``torch.Generator`` on the card in one normal
and one uniform draw: the selector's linear and conv weights and biases
U(+-1/sqrt(fan_in)), its group norms 1 and 0, negative tokens and Fourier
matrix N(0, 1) (the port's init rules); RoBERTa's linear weights and
embeddings N(0, 0.02), biases 0, layer norms 1 and 0 (HF's). fp32, the
configuration's precision.
"""

from __future__ import annotations

import math

import torch
from torch import nn


def selection_config(config: dict, size: str = "large"):
    from benchmark.reference.selection.model import SelectionConfig
    m = dict(config["model"])
    if size != "large":
        m.update(config["tiny_model"])
    return SelectionConfig.from_dict(m)


def roberta_config(size: str = "large"):
    from benchmark.reference.selection.text import RobertaConfig
    return RobertaConfig.large() if size == "large" else RobertaConfig.tiny()


def _draw(specs, seed: int, device) -> dict:
    """specs: (name, shape, kind, arg) with kind normal (std), uniform
    (bound) or const (value)."""
    n_norm = sum(math.prod(s) for _, s, k, _ in specs if k == "normal")
    n_unif = sum(math.prod(s) for _, s, k, _ in specs if k == "uniform")
    gen = torch.Generator(device=device).manual_seed(int(seed))
    normal = torch.randn(n_norm, generator=gen, device=device)
    unif = torch.rand(n_unif, generator=gen, device=device)
    out, on, ou = {}, 0, 0
    for name, shape, kind, arg in specs:
        k = math.prod(shape)
        if kind == "normal":
            out[name] = (normal[on:on + k] * arg).reshape(shape)
            on += k
        elif kind == "uniform":
            out[name] = ((unif[ou:ou + k] * 2.0 - 1.0) * arg).reshape(shape)
            ou += k
        else:
            out[name] = torch.full(shape, float(arg), device=device)
    return out


def _owners(model) -> dict:
    owner = {}
    for mname, mod in model.named_modules():
        for pname, _ in list(mod.named_parameters(recurse=False)) + list(
                mod.named_buffers(recurse=False)):
            owner[f"{mname}.{pname}" if mname else pname] = (mod, pname)
    return owner


@torch.no_grad()
def selection_state_dict(config: dict, seed: int, device="cuda",
                         size: str = "large") -> dict:
    from benchmark.reference.selection.layers import (MaskedGroupNorm,
                                                      WSConv1d)
    from benchmark.reference.selection.model import SelectionModel
    with torch.device("meta"):
        model = SelectionModel(selection_config(config, size))
    owner = _owners(model)
    specs = []
    for name, t in model.state_dict().items():
        mod, leaf = owner[name]
        shape = tuple(t.shape)
        if isinstance(mod, (nn.Linear, WSConv1d)):
            fan_in = math.prod(mod.weight.shape[1:])
            specs.append((name, shape, "uniform", fan_in ** -0.5))
        elif isinstance(mod, MaskedGroupNorm):
            specs.append((name, shape, "const",
                          1.0 if leaf == "weight" else 0.0))
        else:   # negative tokens, the Fourier matrix
            specs.append((name, shape, "normal", 1.0))
    return _draw(specs, seed, device)


@torch.no_grad()
def roberta_state_dict(seed: int, device="cuda", size: str = "large") -> dict:
    from benchmark.reference.selection.text import RobertaEncoder
    with torch.device("meta"):
        model = RobertaEncoder(roberta_config(size))
    owner = _owners(model)
    specs = []
    for name, t in model.state_dict().items():
        mod, leaf = owner[name]
        shape = tuple(t.shape)
        if isinstance(mod, nn.LayerNorm):
            specs.append((name, shape, "const",
                          1.0 if leaf == "weight" else 0.0))
        elif leaf == "bias":
            specs.append((name, shape, "const", 0.0))
        elif isinstance(mod, (nn.Linear, nn.Embedding)):
            specs.append((name, shape, "normal", 0.02))
        else:
            raise KeyError(f"no init rule for {name}")
    return _draw(specs, seed + 1, device)
