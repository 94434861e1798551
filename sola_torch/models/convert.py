"""Selection-model weights between the JAX package's parameter tree and the
port's (reference-named) state dict.

Counterpart of ``sola_tpu/models/convert.py``. The port's
``SelectionModel`` uses the reference checkpoint's names (``epoch_N.pth``,
module/module.py), so a reference checkpoint loads into it with a plain
``load_state_dict``; these functions carry JAX ``{"params", "buffers"}``
trees (as numpy) across, transposing layouts:

    flax Conv kernel (k, in, out)   <-> torch Conv1d weight (out, in, k)
    flax Dense kernel (in, out)     <-> torch Linear weight (out, in)
    flax GroupNorm scale/bias       <-> weight/bias
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from sola_torch.models.selection import CONV_SEQ_IDX, NORM_SEQ_IDX

ATTN_NAMES = ("obj_attn", "motion_attn", "object2lang_attn")
NORM_NAMES = ("norm_obj", "norm_motion", "norm_lang")
PROJ_NAMES = ("q_proj", "k_proj", "v_proj", "out_proj")


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype=np.float32)


def _n_layers(params: Mapping) -> int:
    return sum(1 for k in params if k.startswith("align_"))


def state_dict_from_jax_params(variables: Mapping) -> dict:
    """JAX ``{"params", "buffers"}`` (arrays or numpy) -> the port's state
    dict of CPU float32 tensors (a numpy copy of
    ``params_to_torch_state_dict``)."""
    params, buffers = variables["params"], variables["buffers"]
    state = {}
    for i, seq in enumerate(CONV_SEQ_IDX):
        conv = params[f"conv_{i}"]
        state[f"short_motion_encoder.{seq}.weight"] = np.transpose(
            _np(conv["kernel"]), (2, 1, 0))
        state[f"short_motion_encoder.{seq}.bias"] = _np(conv["bias"])
    for i, seq in enumerate(NORM_SEQ_IDX):
        norm = params[f"conv_norm_{i}"]
        state[f"short_motion_encoder.{seq}.weight"] = _np(norm["scale"])
        state[f"short_motion_encoder.{seq}.bias"] = _np(norm["bias"])
    for layer in range(_n_layers(params)):
        prefix = f"object_lang_align_layers.{layer}"
        node = params[f"align_{layer}"]
        for attn in ATTN_NAMES:
            for proj in PROJ_NAMES:
                dense = node[attn][proj]
                state[f"{prefix}.{attn}.{proj}.weight"] = _np(
                    dense["kernel"]).T
                state[f"{prefix}.{attn}.{proj}.bias"] = _np(dense["bias"])
        for i, ours in enumerate(NORM_NAMES):
            state[f"{prefix}.norm.{i}.weight"] = _np(node[ours]["scale"])
            state[f"{prefix}.norm.{i}.bias"] = _np(node[ours]["bias"])
    state["negative_token.weight"] = _np(params["negative_token"])
    state["positional_encoding_gaussian_matrix"] = _np(
        buffers["positional_encoding_gaussian"])
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in state.items()}


def jax_params_from_state_dict(state: Mapping) -> dict:
    """The inverse: a reference-named state dict (tensors or numpy) ->
    ``{"params", "buffers"}`` of numpy arrays in the JAX package's tree,
    for export (a copy of ``torch_state_dict_to_params``)."""
    n_layers = 1 + max(int(k.split(".")[1]) for k in state
                       if k.startswith("object_lang_align_layers."))
    params: dict = {}
    for i, seq in enumerate(CONV_SEQ_IDX):
        params[f"conv_{i}"] = {
            "kernel": np.transpose(
                _np(state[f"short_motion_encoder.{seq}.weight"]), (2, 1, 0)),
            "bias": _np(state[f"short_motion_encoder.{seq}.bias"])}
    for i, seq in enumerate(NORM_SEQ_IDX):
        params[f"conv_norm_{i}"] = {
            "scale": _np(state[f"short_motion_encoder.{seq}.weight"]),
            "bias": _np(state[f"short_motion_encoder.{seq}.bias"])}
    for layer in range(n_layers):
        prefix = f"object_lang_align_layers.{layer}"
        node: dict = {}
        for attn in ATTN_NAMES:
            node[attn] = {
                proj: {"kernel": _np(state[f"{prefix}.{attn}.{proj}.weight"]).T,
                       "bias": _np(state[f"{prefix}.{attn}.{proj}.bias"])}
                for proj in PROJ_NAMES}
        for i, ours in enumerate(NORM_NAMES):
            node[ours] = {"scale": _np(state[f"{prefix}.norm.{i}.weight"]),
                          "bias": _np(state[f"{prefix}.norm.{i}.bias"])}
        params[f"align_{layer}"] = node
    params["negative_token"] = _np(state["negative_token.weight"])
    buffers = {"positional_encoding_gaussian":
               _np(state["positional_encoding_gaussian_matrix"])}
    return {"params": params, "buffers": buffers}
