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
