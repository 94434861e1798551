"""Checkpoints that survive a kill: the port's ``save_checkpoint`` writes
each file under a temporary name and renames it, the weights first and the
resume file last, so a save cut off while it writes is never resumed from
(the JAX package commits orbax directories the same way). A crash inside
either file's ``torch.save`` leaves the newest checkpoint at the epoch
before, and ``train(resume=True)`` then ends bit for bit equal to an
unbroken run, dropout on; the temporary file of a killed save is never
taken for a checkpoint; the written weights still load strictly in the
port and in the JAX package; and ``scripts/torch_quality_run.py`` kills
and resumes the train CLI at a tiny corpus on the CPU."""

import io
import json
import os
import shutil
import signal
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax

from sola_tpu.train import state as jstate
from sola_torch.data import synthetic
from sola_torch.models.selection import SelectionConfig, SelectionModel
from sola_torch.models.text import HashTextEncoder
from sola_torch.train import state as tstate
from sola_torch.train.loop import train

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("resume")
    return synthetic.generate(str(root / "data"), n_videos=2, n_frames=16,
                              n_objects=2, n_distractors=2)


def make_configs(root, ds, n_epochs):
    """A tiny selection config with dropout on, the flash route's plain
    version and 2 steps an epoch."""
    cfgs = {k: dict(v) if isinstance(v, dict) else v
            for k, v in ds["configs"].items()}
    for split in ("train", "valid", "test"):
        cfgs[split] = dict(cfgs[split], batch_size=2)
    return {
        "exp_name": "resume",
        "model": {"object_token_dim": 256, "lang_token_dim": 64,
                  "n_layers": 1, "n_negative": 4, "dropout_p": 0.2,
                  "attn_dropout_p": 0.1, "n_groups": 8,
                  "n_groups_module": 8, "use_pallas_attention": True},
        "train": {"n_epochs": n_epochs, "pred_threshold": 0.5,
                  "temperature": 0.07, "alignment_weight": 0.3, "lr": 1e-4,
                  "lr_factor": 0.5, "lr_patience": 0, "grad_clip_norm": 1.0,
                  "positive_metric": "iou", "positive_threshold": 0.7,
                  "positive_weight": 1.5},
        "dataset": cfgs,
        "results": {"output_dir": os.path.join(root, "TRAIN")},
    }


def out_dir(configs):
    return os.path.join(configs["results"]["output_dir"], "resume", "mevis")


def run(configs, resume=False, logs=None):
    return train(configs, max_steps_per_epoch=2,
                 text_encoder=HashTextEncoder(hidden_size=64, vocab_size=128,
                                              device="cpu"),
                 log_fn=(logs.append if logs is not None
                         else lambda *a: None),
                 resume=resume, device="cpu")


def read(path):
    with open(path) as f:
        return f.read()


@pytest.mark.parametrize("cut", ["weights", "resume"])
def test_save_cut_off_is_never_resumed(corpus, tmp_path, monkeypatch, cut):
    """torch.save of epoch 2's weights or resume file writes half its bytes
    and raises: epoch 1 stays the newest checkpoint, no partial file is
    left under a checkpoint's name, and a resumed run ends bit for bit
    equal to an unbroken one (weights, AdamW state, log.txt)."""
    straight_cfg = make_configs(str(tmp_path / "straight"), corpus, 3)
    straight = run(straight_cfg)
    cfg = make_configs(str(tmp_path / "cut"), corpus, 3)
    real_save = torch.save

    def half_save(obj, f, *args, **kwargs):
        is_resume = isinstance(obj, dict) and "optimizer" in obj
        epoch_2 = (obj.get("epoch") == 2 if is_resume
                   else os.path.exists(os.path.join(out_dir(cfg),
                                                    "epoch_1.resume.pth"))
                   and not os.path.exists(os.path.join(out_dir(cfg),
                                                       "epoch_2.pth")))
        if epoch_2 and is_resume == (cut == "resume"):
            buf = io.BytesIO()
            real_save(obj, buf, *args, **kwargs)
            data = buf.getvalue()
            if hasattr(f, "write"):
                f.write(data[:len(data) // 2])
            else:
                with open(f, "wb") as out:
                    out.write(data[:len(data) // 2])
            raise OSError("disk went away")
        return real_save(obj, f, *args, **kwargs)

    monkeypatch.setattr(torch, "save", half_save)
    with pytest.raises(OSError, match="disk went away"):
        run(cfg)
    monkeypatch.setattr(torch, "save", real_save)
    names = sorted(os.listdir(out_dir(cfg)))
    assert "epoch_2.resume.pth" not in names
    assert ("epoch_2.pth" in names) == (cut == "resume")
    assert not [n for n in names if n.endswith(".tmp")], names
    assert tstate.latest_checkpoint_epoch(out_dir(cfg)) == 1

    logs = []
    resumed = run(cfg, resume=True, logs=logs)
    assert any("resumed from epoch 1" in str(x) for x in logs)
    for (name, a), b in zip(straight.state_dict().items(),
                            resumed.state_dict().values()):
        assert torch.equal(a, b), name
    for e in (2, 3):
        want, got = (torch.load(os.path.join(out_dir(c), f"epoch_{e}."
                                             "resume.pth"),
                                weights_only=True)
                     for c in (straight_cfg, cfg))
        assert want["step"] == got["step"] and want["epoch"] == got["epoch"]
        for k, s in want["optimizer"]["state"].items():
            for key, t in s.items():
                assert torch.equal(t, got["optimizer"]["state"][k][key]), \
                    (e, k, key)
    assert (read(os.path.join(out_dir(straight_cfg), "log.txt"))
            == read(os.path.join(out_dir(cfg), "log.txt")))


def test_killed_save_leaves_no_checkpoint(corpus, tmp_path):
    """With epoch 2's weights in place, a process SIGKILLed inside the
    resume file's save leaves its temporary file behind:
    latest_checkpoint_epoch still says 1, a resume restores epoch 1, and
    the next save of epoch 2 completes beside the leftover."""
    cfg = make_configs(str(tmp_path), corpus, 1)
    run(cfg)
    ckpt = out_dir(cfg)
    code = f"""
import os, signal, torch
from sola_torch.train import state
def killed(obj, f, *a, **k):
    f.write(b"partial bytes of a resume file")
    f.flush()
    os.kill(os.getpid(), signal.SIGKILL)
torch.save = killed
state.save_atomic({{"epoch": 2}}, {os.path.join(ckpt, "epoch_2.resume.pth")!r})
"""
    shutil.copy(os.path.join(ckpt, "epoch_1.pth"),
                os.path.join(ckpt, "epoch_2.pth"))
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          env=dict(os.environ, PYTHONPATH=ROOT),
                          capture_output=True, timeout=120)
    assert proc.returncode == -signal.SIGKILL, proc.stderr
    leftovers = [n for n in os.listdir(ckpt) if n.endswith(".tmp")]
    assert len(leftovers) == 1 and leftovers[0].startswith(
        ".epoch_2.resume.pth."), leftovers
    assert tstate.latest_checkpoint_epoch(ckpt) == 1
    cfg["train"]["n_epochs"] = 2
    logs = []
    run(cfg, resume=True, logs=logs)
    assert any("resumed from epoch 1" in str(x) for x in logs)
    assert tstate.latest_checkpoint_epoch(ckpt) == 2
    assert read(os.path.join(ckpt, "log.txt")).count("TRAIN EPOCH") == 2

    # the atomically written weights still load strictly in both packages
    weights = os.path.join(ckpt, "epoch_2.pth")
    state = torch.load(weights, weights_only=True)
    SelectionModel(SelectionConfig.from_dict(cfg["model"])).load_state_dict(
        state, strict=True)
    leaves = jax.tree_util.tree_leaves(
        jstate.load_torch_weights(weights, n_layers=1))
    assert (sum(np.size(x) for x in leaves)
            == sum(v.numel() for v in state.values()))


def test_quality_run_script_kills_and_resumes_on_cpu(tmp_path):
    """scripts/torch_quality_run.py at a tiny corpus on the CPU: the train
    CLI killed inside epoch 2 and resumed ends bit for bit equal to the
    unbroken run, and the eval CLI scores epoch 3."""
    out = tmp_path / "out"
    # where transformers is not installed the CLIs take the hash encoder
    # at once; here its import alone would take most of the test's time
    shim = tmp_path / "shim" / "transformers"
    shim.mkdir(parents=True)
    (shim / "__init__.py").write_text(
        "raise ImportError('transformers left out of this test')\n")
    proc = subprocess.run(
        [sys.executable, os.path.join(ROOT, "scripts", "torch_quality_run.py"),
         "--device", "cpu", "--n_videos", "4", "--epochs", "3",
         "--kill_after_epoch", "1", "--eval_epochs", "3", "--batch_size", "4",
         "--out", str(out)],
        cwd=ROOT, env=dict(os.environ, OMP_NUM_THREADS="2",
                           TMPDIR=str(tmp_path),
                           PYTHONPATH=str(tmp_path / "shim")),
        capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    summary = json.loads((out / "summary.json").read_text())
    assert summary["resume_bit_equal"] is True
    assert summary["kill"]["newest_checkpoint_after_kill"] == 1
    assert summary["compared"]["checkpoint_files"] == [
        "epoch_2.pth", "epoch_2.resume.pth", "epoch_3.pth",
        "epoch_3.resume.pth"]
    assert summary["compared"]["log_lines"] == 15
    assert 0.0 <= summary["jf_by_epoch"]["3"]["mean_JF"] <= 1.0
    assert (out / "valid_u_metrics_3epoch.json").exists()
    assert "TRAIN EPOCH 003" in (out / "log.txt").read_text()
