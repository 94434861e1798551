"""YAML config loading with dotted-path CLI overrides.

Mirrors the reference's config surface (configs/mevis/default.yaml; loader at
train.py:254-292, eval.py:44-93, inference.py:100-147) with one deliberate
fix: the reference folds unknown ``--key value`` flags into *top-level* keys
only, so nested knobs like ``train.lr`` are silently impossible to override
(SURVEY.md §2.5). Here ``--train.lr 1e-5`` walks the nested dict. Plain keys
still land at the top level for reference-compatible invocations.
"""

from __future__ import annotations

import copy
import os
from typing import Any, Optional, Sequence

import yaml

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEFAULT_CONFIG_DIR = os.path.join(_REPO_ROOT, "configs")


def coerce_value(value: str) -> Any:
    """The reference's naive str -> int/float/bool coercion (train.py:270-273),
    extended to scientific notation and negatives so ``--train.lr 5e-6`` works."""
    v = value
    if v.lower() in ("true", "false"):
        return v.lower() == "true"
    try:
        iv = int(v)
        return iv
    except ValueError:
        pass
    try:
        return float(v)
    except ValueError:
        pass
    return value


def parse_unknown_args(unknown: Sequence[str]) -> dict[str, Any]:
    """Parse ``--key value`` / bare ``--flag`` pairs (train.py:263-278)."""
    overrides: dict[str, Any] = {}
    i = 0
    while i < len(unknown):
        tok = unknown[i]
        if tok.startswith("--"):
            key = tok[2:]
            if i + 1 < len(unknown) and not unknown[i + 1].startswith("--"):
                overrides[key] = coerce_value(unknown[i + 1])
                i += 2
            else:
                overrides[key] = True
                i += 1
        else:
            i += 1
    return overrides


def set_by_path(configs: dict, key: str, value: Any) -> None:
    """Set a possibly-dotted key. Intermediate dicts are created as needed."""
    parts = key.split(".")
    node = configs
    for p in parts[:-1]:
        nxt = node.get(p)
        if not isinstance(nxt, dict):
            nxt = {}
            node[p] = nxt
        node = nxt
    node[parts[-1]] = value


def apply_overrides(configs: dict, overrides: dict[str, Any]) -> dict:
    for key, value in overrides.items():
        set_by_path(configs, key, value)
    return configs


def load_config(name_or_path: str,
                config_dir: Optional[str] = None,
                overrides: Optional[Sequence[str] | dict[str, Any]] = None) -> dict:
    """Load ``configs/<name>.yaml`` (or an explicit path) and apply overrides."""
    config_dir = config_dir or DEFAULT_CONFIG_DIR
    if os.path.isfile(name_or_path):
        path = name_or_path
    else:
        path = os.path.join(config_dir, f"{name_or_path}.yaml")
    with open(path, "r") as f:
        configs = yaml.safe_load(f)
    if overrides:
        if not isinstance(overrides, dict):
            overrides = parse_unknown_args(list(overrides))
        apply_overrides(configs, overrides)
    return configs


# ---------------------------------------------------------------------------
# Output-dir templating, byte-compatible with the reference layout.
# ---------------------------------------------------------------------------

def train_output_dir(configs: dict) -> str:
    """SOLA/TRAIN/<exp_name>/<train data_name> (train.py:282-287)."""
    return os.path.join(
        configs["results"]["output_dir"],
        configs["exp_name"],
        configs["dataset"]["train"]["data_name"],
    )


def eval_output_dir(configs: dict, pred_threshold: float, epoch: int) -> str:
    """SOLA/EVAL/<exp>/<valid data_name>/pred_threshold_*/epoch_* (eval.py:81-87)."""
    return os.path.join(
        configs["results"]["eval_output_dir"],
        configs["exp_name"],
        configs["dataset"]["valid"]["data_name"],
        f"pred_threshold_{str(pred_threshold).replace('.', '')}",
        f"epoch_{epoch}",
    )


def inference_output_dir(configs: dict, pred_threshold: float, epoch: int) -> str:
    """SOLA/INFERENCE/<exp>/<test data_name>/pred_threshold_*/epoch_*
    (inference.py:137-143)."""
    return os.path.join(
        configs["results"]["test_output_dir"],
        configs["exp_name"],
        configs["dataset"]["test"]["data_name"],
        f"pred_threshold_{str(pred_threshold).replace('.', '')}",
        f"epoch_{epoch}",
    )


def finalize_train_configs(configs: dict) -> dict:
    """Resolve the train output dir in-place, like train.py:282-290."""
    configs = copy.deepcopy(configs)
    configs["results"]["output_dir"] = train_output_dir(configs)
    os.makedirs(configs["results"]["output_dir"], exist_ok=True)
    return configs
