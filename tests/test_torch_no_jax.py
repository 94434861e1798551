"""The port stands alone: every sola_torch module imports with jax, flax and
sola_tpu made unimportable, no source imports them, and none uses a library
attention or torch.compile. Entry points default to CUDA and refuse to run
without it unless the caller asks for the CPU."""

import os
import pkgutil
import re
import subprocess
import sys

import pytest

import sola_torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "sola_torch")
BLOCKED = ("jax", "jaxlib", "flax", "optax", "orbax", "sola_tpu")


def _modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        sola_torch.__path__, prefix="sola_torch."))


def _sources():
    for dirpath, _, files in os.walk(PKG):
        for f in files:
            if f.endswith((".py", ".cu", ".cuh", ".cpp")):
                yield os.path.join(dirpath, f)


def test_every_module_imports_without_jax():
    mods = _modules()
    assert "sola_torch.trackgen.tokens_grid" in mods
    for name in ("config", "cli.train", "data.dataset", "data.device_cache",
                 "data.synthetic", "models.attention", "models.convert",
                 "models.layers", "models.selection", "models.text",
                 "train.loop", "train.loss", "train.schedule", "train.state",
                 "trackgen.sam2.amg", "trackgen.prompts_grid", "core.ccl",
                 "eval.evaluator", "eval.inference", "eval.metrics",
                 "cli.eval", "cli.inference", "utils.viz", "utils.profiling",
                 "trackgen.sam2.packed", "trackgen.packed_engine",
                 "trackgen.tokens_gt", "parallel.distributed",
                 "parallel.mesh", "parallel.tp", "parallel.cp"):
        assert f"sola_torch.{name}" in mods, name
    code = f"""
import importlib.abc, sys
BLOCKED = {BLOCKED!r}
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError("blocked: " + name)
        return None
sys.meta_path.insert(0, Block())
for m in {mods!r}:
    importlib.import_module(m)
assert not any(k.split(".")[0] in BLOCKED for k in sys.modules), \\
    [k for k in sys.modules if k.split(".")[0] in BLOCKED]
print("ok", len({mods!r}))
"""
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("ok")


IMPORT_RE = re.compile(
    r"^\s*(import|from)\s+(" + "|".join(BLOCKED) + r")\b", re.M)
LIBRARY_RE = re.compile(r"scaled_dot_product_attention|torch\.compile|"
                        r"flash_attn\b|cudnn_attention|xformers")


@pytest.mark.parametrize("check", ["jax_imports", "library_kernels"])
def test_sources(check):
    pattern = IMPORT_RE if check == "jax_imports" else LIBRARY_RE
    bad = []
    for path in _sources():
        with open(path) as f:
            text = f.read()
        bad += [f"{os.path.relpath(path, ROOT)}: {m.group(0).strip()}"
                for m in pattern.finditer(text)]
    assert not bad, bad


def test_entry_points_default_to_cuda(monkeypatch):
    import torch

    from sola_torch.device import resolve_device
    from sola_torch.trackgen.sam2.convert import build_sam2
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_sam2(size="tiny")
    assert resolve_device("cpu").type == "cpu"


def test_gdino_entry_points_default_to_cuda(monkeypatch, tmp_path):
    """load_grounding_dino, load_sam2_image_predictor and both CLIs of the
    GroundingDINO slice refuse to run without CUDA unless asked for the
    CPU."""
    import json

    import torch

    from sola_torch.trackgen import prompts_gdino, tokens_gdino
    from sola_torch.trackgen.gdino.model import (GDINOConfig,
                                                 load_grounding_dino)
    from sola_torch.trackgen.sam2.convert import load_sam2_image_predictor
    from sola_torch.trackgen.sam2.model import SAM2Config
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        load_grounding_dino(None, cfg=GDINOConfig.tiny_test())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        load_sam2_image_predictor(None, cfg=SAM2Config.tiny_test(64))
    data_dir = tmp_path / "datasets" / "mevis" / "valid"
    data_dir.mkdir(parents=True)
    (data_dir / "meta_expressions.json").write_text(json.dumps(
        {"videos": {}}))
    argv = ["--data_root", str(tmp_path), "--output_root", str(tmp_path),
            "--data_type", "valid"]
    for main in (prompts_gdino.main, tokens_gdino.main):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            main(argv)
    assert load_grounding_dino(None, cfg=GDINOConfig.tiny_test(),
                               device="cpu").device.type == "cpu"


def test_train_entry_points_default_to_cuda(monkeypatch, tmp_path):
    """The selection trainer and its CLI refuse to run without CUDA unless
    asked for the CPU; the CPU runs are in tests/test_torch_train.py."""
    import torch

    from sola_torch.cli import train as train_cli
    from sola_torch.train.loop import train
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train({})
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_cli.main(["--config", "mevis/default"])


def test_grid_and_eval_entry_points_default_to_cuda(monkeypatch, tmp_path):
    """prompts_grid and the eval and inference CLIs refuse to run without
    CUDA unless asked for the CPU; the CPU runs are in
    tests/test_torch_amg.py and tests/test_torch_eval.py."""
    import torch

    from sola_torch.cli import eval as eval_cli
    from sola_torch.cli import inference as inference_cli
    from sola_torch.trackgen import prompts_grid
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    frames = tmp_path / "datasets" / "mevis" / "valid_u" / "JPEGImages"
    frames.mkdir(parents=True)
    argv = ["--data_root", str(tmp_path), "--output_root", str(tmp_path)]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        prompts_grid.main(argv, amg_factory=lambda: None)
    prompts_grid.main(argv + ["--device", "cpu"], amg_factory=lambda: None)
    for main in (eval_cli.main, inference_cli.main):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            main(["--config", "mevis/default", "--eval_weight_epoch", "0"])
