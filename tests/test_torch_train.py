"""The port's selection training against the JAX package's: the losses, one
clipped AdamW step against optax's, and ``train()`` for 2 epochs x 2 steps
in both packages from the same initial weights and hash-encoder table
(Pallas attention route, dropout 0): ``log.txt`` numbers and confusion
counts; then the cross-package checkpoint load, bit-exact resume with
dropout on, the device token cache of each split, and the CLI."""

import os
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sola_tpu.data import synthetic as jsynthetic
from sola_tpu.models.selection import SelectionConfig as JConfig
from sola_tpu.models.text import HashTextEncoder as JHashText
from sola_tpu.train import loss as jloss
from sola_tpu.train import state as jstate
from sola_torch.cli import train as tcli
from sola_torch.models.text import HashTextEncoder
from sola_torch.train import loss as tloss
from sola_torch.train import state as tstate

# log.txt prints 4 decimals: numbers that differ by float32 rounding can
# round to neighbouring last digits
LOG_ATOL = 1.5e-4


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


def _loss_inputs(seed=0, b=3, n=6, d=32, m=5):
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((b, n), dtype=np.float32) * 3
    tokens = rng.standard_normal((b, n, d), dtype=np.float32)
    labels = (rng.random((b, n)) > 0.6).astype(np.float32)
    pos = rng.standard_normal((b, 1, d), dtype=np.float32)
    neg = rng.standard_normal((b, m, d), dtype=np.float32)
    mask = rng.random((b, n)) > 0.2
    return logits, tokens, labels, pos, neg, mask


@pytest.mark.parametrize("masked", [False, True])
def test_losses_match_jax(masked):
    logits, tokens, labels, pos, neg, mask = _loss_inputs()
    mask = mask if masked else None
    kw = dict(temperature=0.07, positive_weight=1.5, alignment_weight=0.3)
    _, ref = jloss.total_loss(
        jnp.asarray(logits), jnp.asarray(tokens), jnp.asarray(labels),
        jnp.asarray(pos), jnp.asarray(neg),
        track_mask=None if mask is None else jnp.asarray(mask), **kw)
    _, got = tloss.total_loss(
        *(torch.from_numpy(x) for x in (logits, tokens, labels, pos, neg)),
        track_mask=None if mask is None else torch.from_numpy(mask), **kw)
    for k in ("total", "bce", "alignment"):
        np.testing.assert_allclose(float(got[k]), float(ref[k]), rtol=1e-5,
                                   err_msg=k)


@pytest.mark.parametrize("clip", [0.05, 100.0])
def test_clipped_adamw_step_matches_optax(clip):
    """One step from the same params and gradients, with the clip active
    (0.05) and idle (100)."""
    rng = np.random.default_rng(1)
    params = {"a": rng.standard_normal((4, 3), dtype=np.float32),
              "b": rng.standard_normal(5, dtype=np.float32)}
    grads = {k: rng.standard_normal(v.shape, dtype=np.float32)
             for k, v in params.items()}
    opt = jstate.make_optimizer(lr=1e-2, grad_clip_norm=clip)
    updates, _ = opt.update(grads, opt.init(params), params)
    ref = {k: np.asarray(params[k] + updates[k]) for k in params}

    tparams = [torch.nn.Parameter(torch.from_numpy(params[k].copy()))
               for k in ("a", "b")]
    for p, k in zip(tparams, ("a", "b")):
        p.grad = torch.from_numpy(grads[k].copy())
    topt = tstate.make_optimizer(tparams, lr=1e-2, grad_clip_norm=clip)
    norm = topt.step()
    want = np.sqrt(sum((g.astype(np.float64) ** 2).sum()
                       for g in grads.values()))
    np.testing.assert_allclose(float(norm), want, rtol=1e-6)
    for p, k in zip(tparams, ("a", "b")):
        np.testing.assert_allclose(p.detach().numpy(), ref[k], atol=1e-6,
                                   err_msg=k)


def make_configs(root, ds, n_epochs=2, **model):
    m = {"object_token_dim": 256, "lang_token_dim": 64, "n_layers": 1,
         "max_temporal_length": 100, "n_negative": 4, "dropout_p": 0.0,
         "attn_dropout_p": 0.0, "norm_type": "group", "n_groups": 8,
         "n_groups_module": 8, "use_pallas_attention": True}
    m.update(model)
    cfgs = {k: dict(v) if isinstance(v, dict) else v
            for k, v in ds["configs"].items()}
    for split in ("train", "valid", "test"):
        cfgs[split] = dict(cfgs[split], batch_size=2)
    return {
        "exp_name": "torchtrain",
        "model": m,
        "train": {"n_epochs": n_epochs, "pred_threshold": 0.5,
                  "temperature": 0.07, "alignment_weight": 0.3, "lr": 1e-4,
                  "lr_factor": 0.5, "lr_patience": 0, "grad_clip_norm": 1.0,
                  "positive_metric": "iou", "positive_threshold": 0.7,
                  "positive_weight": 1.5},
        "dataset": cfgs,
        "eval": {"pred_threshold": 0.5},
        "results": {"output_dir": os.path.join(root, "TRAIN"),
                    "eval_output_dir": os.path.join(root, "EVAL"),
                    "test_output_dir": os.path.join(root, "INFER")},
    }


def out_dir(configs):
    return os.path.join(configs["results"]["output_dir"], "torchtrain",
                        "mevis")


def parse_log(path):
    """(floats, confusion ints) of a log.txt, in order."""
    text = open(path).read()
    counts = [int(x) for x in re.findall(r"(?:TP|FP|FN|TN): (\d+)", text)]
    floats = [float(x) for x in re.findall(r"-?\d+\.\d+", text)]
    return floats, counts


@pytest.fixture(scope="module")
def shared(tmp_path_factory):
    """One synthetic corpus, JAX's initial weights as an .npz, and the JAX
    hash encoder's table."""
    root = tmp_path_factory.mktemp("torchtrain")
    ds = jsynthetic.generate(str(root / "data"), n_videos=2, n_frames=16,
                             n_objects=2, n_distractors=2)
    cfg = JConfig.from_dict(make_configs(str(root), ds)["model"])
    init = jstate.create_train_state(cfg, jstate.make_optimizer(1e-4))
    npz = str(root / "init.npz")
    jstate.export_torch_npz(npz, init, n_layers=cfg.n_layers)
    text = JHashText(hidden_size=64, vocab_size=128)
    return {"root": root, "ds": ds, "npz": npz, "jax_text": text,
            "table": np.asarray(text.table)}


def _torch_text(shared):
    return HashTextEncoder(hidden_size=64, vocab_size=128,
                           table=shared["table"])


@pytest.fixture(scope="module")
def both_runs(shared):
    from sola_tpu.train.loop import train as jax_train
    from sola_torch.train.loop import train as torch_train
    runs = {}
    for name in ("jax", "torch"):
        cfg = make_configs(str(shared["root"] / name), shared["ds"])
        cfg["train"]["init_weights"] = shared["npz"]
        if name == "jax":
            jax_train(cfg, max_steps_per_epoch=2,
                      text_encoder=shared["jax_text"],
                      log_fn=lambda *a: None)
        else:
            runs["model"] = torch_train(cfg, max_steps_per_epoch=2,
                                        text_encoder=_torch_text(shared),
                                        log_fn=lambda *a: None,
                                        device="cpu")
        runs[name] = out_dir(cfg)
    return runs


def test_two_epoch_log_matches_jax(both_runs):
    jf, jc = parse_log(os.path.join(both_runs["jax"], "log.txt"))
    tf, tc = parse_log(os.path.join(both_runs["torch"], "log.txt"))
    text = open(os.path.join(both_runs["torch"], "log.txt")).read()
    assert "TRAIN EPOCH 002" in text and "VALID EPOCH 002" in text
    assert tc == jc and len(tc) == 8
    np.testing.assert_allclose(tf, jf, atol=LOG_ATOL)


def test_checkpoint_reads_in_the_jax_package(both_runs):
    """epoch_2.pth through sola_tpu's load_torch_weights gives the port's
    final weights, and epoch_1.pth differs from them (training moved)."""
    from sola_torch.models import convert as tconvert
    model = both_runs["model"]
    pth = os.path.join(both_runs["torch"], "epoch_2.pth")
    loaded = jstate.load_torch_weights(pth, n_layers=1)
    want = tconvert.jax_params_from_state_dict(model.state_dict())
    leaves = jax.tree_util.tree_leaves_with_path(loaded)
    assert len(leaves) == len(jax.tree_util.tree_leaves(want))
    for path, leaf in leaves:
        got = want
        for key in path:
            got = got[key.key]
        np.testing.assert_array_equal(np.asarray(leaf), got)
    first = tstate.load_torch_weights(
        os.path.join(both_runs["torch"], "epoch_1.pth"))
    final = model.state_dict()
    assert any(not torch.equal(first[k], final[k]) for k in first)
    assert tstate.latest_checkpoint_epoch(both_runs["torch"]) == 2


def test_resume_is_bit_exact_with_dropout(shared, tmp_path):
    from sola_torch.train.loop import train
    drop = dict(dropout_p=0.2, attn_dropout_p=0.1)
    straight_cfg = make_configs(str(tmp_path / "a"), shared["ds"],
                                n_epochs=3, **drop)
    straight = train(straight_cfg, max_steps_per_epoch=2,
                     text_encoder=_torch_text(shared),
                     log_fn=lambda *a: None, device="cpu")
    cfg = make_configs(str(tmp_path / "b"), shared["ds"], n_epochs=1, **drop)
    train(cfg, max_steps_per_epoch=2, text_encoder=_torch_text(shared),
          log_fn=lambda *a: None, device="cpu")
    cfg["train"]["n_epochs"] = 3
    logs = []
    resumed = train(cfg, max_steps_per_epoch=2,
                    text_encoder=_torch_text(shared), log_fn=logs.append,
                    resume=True, device="cpu")
    assert any("resumed from epoch 1" in str(x) for x in logs)
    for (name, a), b in zip(straight.state_dict().items(),
                            resumed.state_dict().values()):
        assert torch.equal(a, b), name
    assert (open(os.path.join(out_dir(straight_cfg), "log.txt")).read()
            == open(os.path.join(out_dir(cfg), "log.txt")).read())


def test_token_cache_keeps_splits_apart(tmp_path):
    """A train and a valid split that share video ids but not tokens (as
    MeViS's valid_u and train do): the device token cache gives the same
    log as direct transfers, so valid batches read their own tokens."""
    from sola_torch.data import synthetic as tsynthetic
    from sola_torch.train.loop import train
    ds = {}
    for split, seed in (("train", 0), ("valid_u", 1)):
        ds = tsynthetic.generate(str(tmp_path / "data"), n_videos=2,
                                 n_frames=16, data_type=split, seed=seed)
    ds["configs"]["train"]["data_type"] = "train"
    logs = []
    for cached in (True, False):
        cfg = make_configs(str(tmp_path / str(cached)), ds, n_epochs=1)
        cfg["train"]["device_token_cache"] = cached
        train(cfg, text_encoder=HashTextEncoder(
            hidden_size=64, vocab_size=128, device="cpu"),
            log_fn=lambda *a: None, device="cpu")
        logs.append(open(os.path.join(out_dir(cfg), "log.txt")).read())
    assert "VALID EPOCH 001" in logs[0] and logs[0] == logs[1]


def test_cli_overrides_reach_nested_keys():
    configs, resume, device = tcli.get_configs(
        ["--config", "mevis/default", "--train.lr", "1e-5",
         "--model.use_pallas_attention", "true", "--dataset.train.batch_size",
         "8", "--resume", "--device", "cpu"])
    assert configs["train"]["lr"] == 1e-5
    assert configs["model"]["use_pallas_attention"] is True
    assert configs["dataset"]["train"]["batch_size"] == 8
    assert configs["train"]["grad_clip_norm"] == 1.0  # the yaml's own value
    assert resume and device == "cpu"


def test_cli_trains_from_a_yaml(shared, tmp_path):
    import yaml
    cfg = make_configs(str(tmp_path), shared["ds"], n_epochs=1)
    cfg["model"]["lang_token_dim"] = 1024  # the hash encoder's default
    path = tmp_path / "tiny.yaml"
    path.write_text(yaml.safe_dump(cfg))
    tcli.main(["--config", str(path), "--device", "cpu",
               "--train.n_epochs", "1", "--model.n_negative", "2"])
    assert os.path.exists(os.path.join(out_dir(cfg), "epoch_1.pth"))
    state = torch.load(os.path.join(out_dir(cfg), "epoch_1.pth"))
    assert state["negative_token.weight"].shape == (2, 1024)
