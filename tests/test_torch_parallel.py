"""The port's distributed modules (sola_torch/parallel) against the JAX
package's on the CPU: 4 gloo processes (tests/torch_parallel_worker.py,
started once for the module, 2 data x 2 model ranks) run a dp x tp train
step by both attention routes, a data-parallel eval forward,
``cp_attention`` over key shards, ``all_sum`` over ``shard_for_host``'s
shares, a 2-epoch ``train()`` with a resumed twin and a sharded
``Evaluator``; this process holds their results against JAX's (4, 2) mesh
step, ``shard_map_attention`` on conftest's 8 virtual devices and the
port's one-process runs. A planted fault (out_proj's forward sum taken
away) must break the train step's bounds."""

import json
import os
import re
import signal
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sola_torch.models.selection import SelectionConfig, SelectionModel
from sola_torch.models.text import HashTextEncoder
from sola_torch.parallel import mesh as tmesh
from sola_torch.parallel import tp
from sola_torch.parallel.distributed import (shard_for_host,
                                             verify_disjoint_coverage)
from sola_torch.train import loop as tloop
from sola_torch.train import state as tstate

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, "tests", "torch_parallel_worker.py")
WORLD = 4
# a hung rank fails its launch, and a test its own limit, well inside the
# tier-1 budget
LAUNCH_TIMEOUT_S = 180
TEST_TIMEOUT_S = 120
TINY = dict(object_token_dim=16, lang_token_dim=64, n_negative=4,
            dropout_p=0.0, attn_dropout_p=0.0, n_groups=4, n_groups_module=4)
TRAIN_CFG = {"positive_weight": 1.5, "alignment_weight": 0.3,
             "temperature": 0.07}
# tests/test_parallel.py's bounds for the dp x tp step: sharded products
# and sums reduce in another order than one device's
LOSS_ATOL, PARAM_ATOL = 1e-5, 1e-4
# log.txt prints 4 decimals: numbers that differ by float32 rounding can
# round to neighbouring last digits
LOG_ATOL = 1.5e-4


@pytest.fixture(autouse=True)
def _limits():
    torch.set_num_threads(2)

    def _expired(*_):
        raise TimeoutError(f"test ran past {TEST_TIMEOUT_S} s")

    old = signal.signal(signal.SIGALRM, _expired)
    signal.alarm(TEST_TIMEOUT_S)
    yield
    signal.alarm(0)
    signal.signal(signal.SIGALRM, old)


def _jax_step_setup():
    """test_parallel.py's tiny config, its initial JAX train state and its
    seeded batch."""
    from sola_tpu.models.selection import SelectionConfig as JConfig
    from sola_tpu.train import state as jstate
    cfg = JConfig(n_layers=2, **TINY)
    optimizer = jstate.make_optimizer(lr=1e-3, grad_clip_norm=1.0)
    tstate0 = jstate.create_train_state(cfg, optimizer)
    rng = np.random.default_rng(42)
    b, n, t, w = 8, 4, 16, 5
    batch = {
        "object_tokens": rng.standard_normal((b, n, t, 16), dtype=np.float32),
        "track_mask": np.ones((b, n), bool),
        "frame_lengths": np.full((b,), t, np.int32),
        "lang_tokens": rng.standard_normal((b, w, 64), dtype=np.float32),
        "lang_mask": np.ones((b, w), bool),
        "pos_tokens": rng.standard_normal((b, 1, 64), dtype=np.float32),
        "labels": (rng.random((b, n)) > 0.5).astype(np.float32),
    }
    return cfg, optimizer, tstate0, batch


def _torch_state(variables) -> dict:
    from sola_torch.models.convert import state_dict_from_jax_params
    return {k: np.asarray(v) for k, v in
            state_dict_from_jax_params(jax.tree_util.tree_map(
                np.asarray, variables)).items()}


def _cp_cases() -> dict:
    """tests/test_cp.py's cases, and one with a batch entry whose keys are
    all masked (every shard empty)."""
    def r(key, shape):
        return np.asarray(jax.random.normal(jax.random.PRNGKey(key), shape,
                                            jnp.float32))
    cases = {}
    b, h, lq, lk, d = 2, 4, 16, 64, 32
    mask = np.ones((b, lk), bool)
    mask[0, 40:] = False  # ragged; the last shards of b=0 fully masked
    mask[1, ::3] = False
    cases["ragged"] = dict(q=r(0, (b, h, lq, d)), k=r(1, (b, h, lk, d)),
                           v=r(2, (b, h, lk, d)), mask=mask)
    b, h, lq, lk, d = 1, 2, 8, 32, 16
    cases["nomask"] = dict(q=r(3, (b, h, lq, d)), k=r(4, (b, h, lk, d)),
                           v=r(5, (b, h, lk, d)))
    b, h, lq, lk, d = 1, 2, 16, 64, 32
    mask = np.ones((b, lk), bool)
    mask[0, 50:] = False
    cases["flash"] = dict(q=r(6, (b, h, lq, d)), k=r(7, (b, h, lk, d)),
                          v=r(8, (b, h, lk, d)), mask=mask)
    b, h, lq, lk, d = 2, 2, 8, 64, 16
    mask = np.ones((b, lk), bool)
    mask[0] = False
    mask[1, :48] = False
    cases["allmasked"] = dict(q=r(9, (b, h, lq, d)), k=r(10, (b, h, lk, d)),
                              v=r(11, (b, h, lk, d)), mask=mask)
    cases["allmasked_flash"] = cases["allmasked"]
    return cases


def _train_configs(root, ds) -> dict:
    cfgs = {k: dict(v) if isinstance(v, dict) else v
            for k, v in ds["configs"].items()}
    for split in ("train", "valid", "test"):
        cfgs[split] = dict(cfgs[split], batch_size=3)
    return {
        "exp_name": "torchmesh",
        "model": {"object_token_dim": 256, "lang_token_dim": 64,
                  "n_layers": 1, "max_temporal_length": 100,
                  "n_negative": 4, "dropout_p": 0.0, "attn_dropout_p": 0.0,
                  "n_groups": 8, "n_groups_module": 8,
                  "use_pallas_attention": True},
        "train": {"n_epochs": 2, "pred_threshold": 0.5, "temperature": 0.07,
                  "alignment_weight": 0.3, "lr": 1e-4, "lr_factor": 0.5,
                  "lr_patience": 0, "grad_clip_norm": 1.0,
                  "positive_metric": "iou", "positive_threshold": 0.7,
                  "positive_weight": 1.5, "n_model": 2},
        "dataset": cfgs, "eval": {"pred_threshold": 0.5},
        "results": {"output_dir": os.path.join(root, "single")},
    }


def _out_dir(workdir, name):
    return os.path.join(workdir, name, "torchmesh", "mevis")


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Writes the inputs, runs the 4 ranks once and returns their
    results."""
    from sola_tpu.models.selection import SelectionConfig as JConfig
    from sola_tpu.models.selection import SelectionModel as JModel
    from sola_torch.data import synthetic
    workdir = str(tmp_path_factory.mktemp("torchparallel"))
    _, _, tstate0, batch = _jax_step_setup()
    inputs = {f"sd2/{k}": v for k, v in _torch_state(
        {"params": tstate0.params, "buffers": tstate0.buffers}).items()}
    inputs.update({f"step/{k}": v for k, v in batch.items()})

    rng = np.random.default_rng(42)
    obj = rng.standard_normal((8, 4, 16, 16), dtype=np.float32)
    lang = rng.standard_normal((8, 5, 64), dtype=np.float32)
    variables = JModel(JConfig(n_layers=1, **TINY)).init(
        jax.random.PRNGKey(0), jnp.asarray(obj[:1]), jnp.asarray(lang[:1]))
    inputs.update({f"sd1/{k}": v for k, v in _torch_state(variables).items()})
    inputs.update({"eval/obj": obj, "eval/lang": lang})
    for case, arrays in _cp_cases().items():
        inputs.update({f"cp_{case}/{k}": v for k, v in arrays.items()})

    ds = synthetic.generate(os.path.join(workdir, "data"), n_videos=3,
                            n_frames=16, n_objects=2, n_distractors=2)
    ds["configs"]["train"]["data_type"] = "valid_u"  # one split, both uses
    configs = _train_configs(workdir, ds)
    inputs["hash_table"] = HashTextEncoder(
        hidden_size=64, vocab_size=128).table.numpy()
    np.savez(os.path.join(workdir, "inputs.npz"), **inputs)
    with open(os.path.join(workdir, "train.json"), "w") as f:
        json.dump({"configs": configs, "eval_weights": os.path.join(
            _out_dir(workdir, "straight"), "epoch_2.pth")}, f)

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = str(s.getsockname()[1])
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, WORKER, workdir, str(r), str(WORLD), port],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(WORLD)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=LAUNCH_TIMEOUT_S)[0])
    finally:
        for p in procs:
            p.kill()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} failed:\n{log[-3000:]}"
    out = dict(np.load(os.path.join(workdir, "out.npz")))
    return {"workdir": workdir, "out": out, "inputs": inputs,
            "configs": configs, "batch": batch, "tstate0": tstate0}


def test_all_sum_over_host_shards(ranks):
    """tests/test_distributed_two_process.py's check over 4 processes."""
    np.testing.assert_array_equal(ranks["out"]["all_sum"], [23.0, 253.0])
    assert verify_disjoint_coverage(23, WORLD)
    assert shard_for_host(list(range(7)), 1, 3) == [1, 4]


def _step_params(out, prefix) -> dict:
    return {k[len(prefix):]: v for k, v in out.items()
            if k.startswith(prefix) and not k.endswith("/loss")}


def _jax_steps(ranks) -> tuple:
    """(loss, torch-named params) of JAX's one-device step and of its
    (4, 2) mesh step."""
    from jax.sharding import NamedSharding, PartitionSpec as P
    from sola_tpu.models.selection import SelectionModel as JModel
    from sola_tpu.parallel.mesh import make_mesh
    from sola_tpu.parallel.tp import shard_train_state
    from sola_tpu.train.loop import make_train_step
    cfg, optimizer, tstate0, batch = _jax_step_setup()
    step = make_train_step(JModel(cfg), optimizer, TRAIN_CFG)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    key = jax.random.PRNGKey(7)
    results = []
    ref_state, ref_metrics = step(tstate0, jbatch, key)
    results.append((float(ref_metrics["total"]), _torch_state(
        {"params": ref_state.params, "buffers": ref_state.buffers})))
    mesh = make_mesh(n_data=4, n_model=2)
    from sola_tpu.train import state as jstate
    state2 = shard_train_state(mesh, jstate.create_train_state(
        cfg, optimizer), optimizer)
    data = NamedSharding(mesh, P("data"))
    with mesh:
        new_state, metrics = step(state2, jax.tree_util.tree_map(
            lambda x: jax.device_put(x, data), jbatch), key)
    results.append((float(metrics["total"]), _torch_state(
        {"params": new_state.params, "buffers": new_state.buffers})))
    return results


def _port_step(ranks, use_flash: bool) -> tuple:
    """The port's one-process step from the same weights and batch."""
    cfg = SelectionConfig(n_layers=2, use_pallas_attention=use_flash, **TINY)
    model = SelectionModel(cfg)
    model.load_state_dict({k[4:]: torch.from_numpy(v) for k, v in
                           ranks["inputs"].items() if k.startswith("sd2/")})
    optimizer = tstate.make_optimizer(model.parameters(), lr=1e-3,
                                      grad_clip_norm=1.0)
    batch = {k: torch.from_numpy(v) for k, v in ranks["batch"].items()}
    metrics = tloop.train_step(model, optimizer, batch, TRAIN_CFG,
                               torch.Generator().manual_seed(0))
    return float(metrics["total"]), {k: v.numpy() for k, v in
                                     model.state_dict().items()}


@pytest.fixture(scope="module")
def jax_steps(ranks):
    return _jax_steps(ranks)


@pytest.mark.parametrize("route", ["plain", "flash"])
def test_dp_tp_train_step_matches_jax(ranks, jax_steps, route):
    """The 2 x 2 mesh step (each data rank 4 rows, each model rank 4 heads
    and half of every conv's channels) against JAX's one-device step, its
    (4, 2) mesh step and the port's one-process step."""
    out = ranks["out"]
    loss = float(out[f"step_{route}/loss"])
    got = _step_params(out, f"step_{route}/")
    refs = list(jax_steps) + [_port_step(ranks, route == "flash")]
    for ref_loss, ref_params in refs:
        np.testing.assert_allclose(loss, ref_loss, atol=LOSS_ATOL)
        assert set(got) == set(ref_params)
        for k, v in ref_params.items():
            np.testing.assert_allclose(got[k], v, atol=PARAM_ATOL,
                                       err_msg=k)
    before = {k[4:]: v for k, v in ranks["inputs"].items()
              if k.startswith("sd2/")}
    assert any(not np.array_equal(got[k], before[k]) for k in got)


def test_planted_out_proj_fault_breaks_the_step(ranks, jax_steps):
    """Without out_proj's forward sum each rank's attention output is half
    a product: the step must leave test (a)'s bounds."""
    out = ranks["out"]
    ref_loss, ref_params = jax_steps[0]
    got = _step_params(out, "step_fault/")
    loss_err = abs(float(out["step_fault/loss"]) - ref_loss)
    param_err = max(float(np.abs(got[k] - v).max())
                    for k, v in ref_params.items())
    assert loss_err > LOSS_ATOL and param_err > PARAM_ATOL, (loss_err,
                                                             param_err)


def test_dropout_keeps_replicas_equal_and_data_ranks_apart(ranks):
    """After a step with dropout every rank's replicated parameters are
    bit-equal; the epoch generators agree within a model group (ranks 0, 1
    and 2, 3) and differ between data ranks."""
    rep = ranks["out"]["dropout/replicated"]
    draws = ranks["out"]["dropout/draws"]
    for r in range(1, WORLD):
        np.testing.assert_array_equal(rep[r], rep[0])
    np.testing.assert_array_equal(draws[1], draws[0])
    np.testing.assert_array_equal(draws[3], draws[2])
    assert not np.array_equal(draws[0], draws[2])


def test_sharded_eval_forward_matches_single_device(ranks):
    """tests/test_parallel.py's eval check: the score map over 4 data
    ranks against JAX's one-device forward and the port's."""
    from sola_tpu.models.selection import SelectionConfig as JConfig
    from sola_tpu.models.selection import SelectionModel as JModel
    inputs = ranks["inputs"]
    obj, lang = inputs["eval/obj"], inputs["eval/lang"]
    model = JModel(JConfig(n_layers=1, **TINY))
    variables = model.init(jax.random.PRNGKey(0), jnp.asarray(obj[:1]),
                           jnp.asarray(lang[:1]))
    ref, _ = model.apply(variables, jnp.asarray(obj), jnp.asarray(lang))
    np.testing.assert_allclose(ranks["out"]["eval/score"], np.asarray(ref),
                               atol=1e-5)
    tmodel = SelectionModel(SelectionConfig(n_layers=1, **TINY))
    tmodel.load_state_dict({k[4:]: torch.from_numpy(v) for k, v in
                            inputs.items() if k.startswith("sd1/")})
    tmodel.eval()
    with torch.no_grad():
        single, _ = tmodel(torch.from_numpy(obj), torch.from_numpy(lang))
    np.testing.assert_allclose(ranks["out"]["eval/score"], single.numpy(),
                               atol=1e-5)


@pytest.mark.parametrize("case", ["ragged", "nomask", "flash", "allmasked",
                                  "allmasked_flash"])
def test_cp_attention_matches_shard_map(ranks, case):
    """cp_attention over 4 key shards against shard_map_attention over 8
    (the Pallas kernel in interpret mode for the flash cases): a shard with
    no valid key weighs 0 under either lse convention, and a row with no
    valid key anywhere is what JAX's gives by the same route (0 plain, the
    mean of V through the kernels)."""
    from jax.sharding import Mesh
    from sola_tpu.parallel.cp import place_cp_inputs, shard_map_attention
    arrays = _cp_cases()[case]
    mesh = Mesh(np.asarray(jax.devices()[:8]), ("model",))
    mask = arrays.get("mask")
    k_s, v_s, m_s = place_cp_inputs(
        mesh, jnp.asarray(arrays["k"]), jnp.asarray(arrays["v"]),
        None if mask is None else jnp.asarray(mask))
    ref = np.asarray(shard_map_attention(
        mesh, jnp.asarray(arrays["q"]), k_s, v_s, m_s,
        use_flash=case.endswith("flash")))
    atol = 5e-5 if case.endswith("flash") else 2e-5
    got = ranks["out"][f"cp_{case}"]
    np.testing.assert_allclose(got, ref, atol=atol, rtol=atol)
    if case == "allmasked":
        assert np.all(got[0] == 0.0)
    if case == "allmasked_flash":
        np.testing.assert_allclose(got[0], np.broadcast_to(
            arrays["v"][0].mean(axis=1, keepdims=True), got[0].shape),
            atol=atol)


def _parse_log(path):
    text = open(path).read()
    return ([float(x) for x in re.findall(r"-?\d+\.\d+", text)],
            [int(x) for x in re.findall(r"(?:TP|FP|FN|TN): (\d+)", text)])


def test_mesh_train_log_matches_one_process(ranks, tmp_path):
    """train() over the 2 x 2 mesh (batches of 3 padded to 4, so a data
    rank holds a padded row) against one process: log.txt numbers within
    its printed precision, confusion counts equal."""
    cfg = json.loads(json.dumps(ranks["configs"]))
    cfg["results"]["output_dir"] = str(tmp_path)
    text = HashTextEncoder(hidden_size=64, vocab_size=128,
                           table=ranks["inputs"]["hash_table"])
    tloop.train(cfg, max_steps_per_epoch=2, text_encoder=text,
                log_fn=lambda *a: None, device="cpu")
    ref = _parse_log(os.path.join(tmp_path, "torchmesh", "mevis",
                                  "log.txt"))
    got = _parse_log(os.path.join(_out_dir(ranks["workdir"], "straight"),
                                  "log.txt"))
    assert got[1] == ref[1] and len(got[1]) == 8
    np.testing.assert_allclose(got[0], ref[0], atol=LOG_ATOL)


def test_mesh_resume_keeps_adam_moments(ranks):
    """A mesh run resumed from epoch 1 ends where the uninterrupted mesh
    run does, bit for bit: weights, AdamW's moments and log.txt."""
    a = _out_dir(ranks["workdir"], "straight")
    b = _out_dir(ranks["workdir"], "resumed")
    assert (open(os.path.join(a, "log.txt")).read()
            == open(os.path.join(b, "log.txt")).read())
    for name in ("epoch_2.pth", "epoch_2.resume.pth"):
        sa = torch.load(os.path.join(a, name), weights_only=True)
        sb = torch.load(os.path.join(b, name), weights_only=True)
        if name.endswith("resume.pth"):
            sa, sb = sa["optimizer"]["state"], sb["optimizer"]["state"]
            assert len(sa) > 0
            sa = {f"{i}/{k}": v for i, e in sa.items() for k, v in e.items()}
            sb = {f"{i}/{k}": v for i, e in sb.items() for k, v in e.items()}
        assert sa.keys() == sb.keys()
        for k in sa:
            assert torch.equal(sa[k], sb[k]), (name, k)


def test_gathered_checkpoint_loads_strictly(ranks):
    """The mesh's checkpoints hold single-device names and shapes: they
    load strictly into a one-process model, and the moments have their
    parameters' shapes."""
    d = _out_dir(ranks["workdir"], "straight")
    cfg = SelectionConfig.from_dict(ranks["configs"]["model"])
    model = SelectionModel(cfg)
    state = torch.load(os.path.join(d, "epoch_2.pth"), weights_only=True)
    model.load_state_dict(state, strict=True)
    opt = torch.load(os.path.join(d, "epoch_2.resume.pth"),
                     weights_only=True)["optimizer"]
    params = [p for p in model.parameters()]
    for i, entry in opt["state"].items():
        assert entry["exp_avg"].shape == params[int(i)].shape


def test_sharded_evaluator_matches_one_process(ranks, tmp_path):
    """The Evaluator over 4 processes (each its shard_for_host share of the
    valid batches) writes the JSONs one process writes, and the confusion
    counts are the one process's, not 4 times them."""
    from sola_torch.eval.evaluator import Evaluator
    cfg = json.loads(json.dumps(ranks["configs"]))
    weights = os.path.join(_out_dir(ranks["workdir"], "straight"),
                           "epoch_2.pth")
    model = tloop.build_model(SelectionConfig.from_dict(cfg["model"]),
                              "cpu", init_weights_path=weights)
    text = HashTextEncoder(hidden_size=64, vocab_size=128,
                           table=ranks["inputs"]["hash_table"])
    Evaluator(model, cfg, 2, text_encoder=text,
              eval_output_dir=str(tmp_path)).evaluate()
    names = sorted(os.listdir(tmp_path))
    assert len(names) == 2
    for name in names:
        ref = json.load(open(os.path.join(tmp_path, name)))
        got = json.load(open(os.path.join(ranks["workdir"], "eval", name)))
        assert got == ref, name
    assert sum(ref[k] for k in ("tp", "fp", "fn", "tn")) > 0


def test_split_rules_match_jax_specs():
    """tp.split_dims names, for every parameter, the torch dim that JAX's
    selection_param_specs shards on the "model" axis (layouts transposed
    as in models/convert.py)."""
    from sola_tpu.models.selection import SelectionConfig as JConfig
    from sola_tpu.parallel.tp import selection_param_specs
    from sola_tpu.train import state as jstate
    cfg = JConfig(n_layers=2, **TINY)
    params = jstate.create_train_state(
        cfg, jstate.make_optimizer(1e-3)).params
    specs = selection_param_specs(params)
    # torch layout of each leaf's "model" axis: a marker array per leaf
    # whose model-sharded axis holds 2 and every other axis 1
    markers = jax.tree_util.tree_map_with_path(
        lambda path, leaf: _axis_marker(specs, path, leaf), params)
    state = _torch_state({"params": markers,
                          "buffers": {"positional_encoding_gaussian":
                                      np.zeros((1, 32), np.float32)}})
    dims = tp.split_dims(state)
    for name, marker in state.items():
        want = [i for i in range(marker.ndim)
                if marker.shape[i] > 1 and np.all(
                    np.moveaxis(marker, i, 0)[1] == 2.0)]
        assert dims[name] == (want[0] if want else None), name
    assert sum(d is not None for d in dims.values()) > 0


def _axis_marker(specs, path, leaf):
    """An array of ``leaf``'s shape that is 2.0 along the axis JAX's spec
    shards on "model" at indices >= 1, and 1.0 elsewhere."""
    spec = specs
    for p in path:
        spec = spec[p.key]
    axes = tuple(spec)
    marker = np.ones(leaf.shape, np.float32)
    for i, a in enumerate(axes):
        if a == "model":
            idx = [slice(None)] * leaf.ndim
            idx[i] = slice(1, None)
            marker[tuple(idx)] = 2.0
    return marker


@pytest.mark.parametrize("n_data", [1, 2, 3])
def test_shard_batch_matches_jax_padding(n_data):
    """Every data index's rows, in order, make up sola_tpu's pad_batch_to
    of the batch to a multiple of n_data; a padded entry is PAD_ENTRY."""
    from sola_tpu.parallel.mesh import PAD_ENTRY as JPAD
    from sola_tpu.parallel.mesh import pad_batch_to as jpad
    rng = np.random.default_rng(0)
    raw = {"track_mask": rng.random((5, 3)) > 0.5,
           "labels": {"iou": rng.random((5, 3)).astype(np.float32)},
           "object_token_rows": [rng.random((3, 2)) for _ in range(5)],
           "expression": [f"e{i}" for i in range(5)],
           "object_tokens": None}
    target = -(-5 // n_data) * n_data
    ref = jpad(raw, target)
    shards = [tmesh.shard_batch(tmesh.Mesh(n_data, 2, r * 2), raw)
              for r in range(n_data)]
    np.testing.assert_array_equal(
        np.concatenate([s["track_mask"] for s in shards]), ref["track_mask"])
    np.testing.assert_array_equal(
        np.concatenate([s["labels"]["iou"] for s in shards]),
        ref["labels"]["iou"])
    rows = [r for s in shards for r in s["object_token_rows"]]
    for a, b in zip(rows, ref["object_token_rows"]):
        np.testing.assert_array_equal(a, b)
    expr = [e for s in shards for e in s["expression"]]
    assert expr == list(ref["expression"])
    assert [e is tmesh.PAD_ENTRY for e in expr] == [
        e is JPAD for e in ref["expression"]]


_FAKE_NVCC = """#!{python}
import os, sys, time
out = sys.argv[sys.argv.index("-o") + 1]
with open(os.path.join(os.path.dirname(out), "runs.log"), "a") as f:
    f.write(str(os.getpid()) + chr(10))
time.sleep(1.0)
with open(out, "wb") as f:
    f.write(b"library")
"""

_BUILD_SCRIPT = """
import sys
sys.path.insert(0, {root!r})
from sola_torch.ops import kernel_build as kb
kb.BUILD_DIR = sys.argv[1]
kb._nvcc = lambda: sys.argv[2]
so_path, seconds, log = kb._complete("flash_attn_fwd",
                                     kb._start("flash_attn_fwd"))
print(so_path, open(so_path, "rb").read().decode())
"""


def test_kernel_build_is_safe_across_processes(tmp_path):
    """Two processes asking at once for one library: one compiler run,
    both get the finished file, no partial file is left."""
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(_FAKE_NVCC.format(python=sys.executable))
    nvcc.chmod(0o755)
    script = tmp_path / "build_one.py"
    script.write_text(_BUILD_SCRIPT.format(root=ROOT))
    build = tmp_path / "build"
    procs = [subprocess.Popen([sys.executable, str(script), str(build),
                               str(nvcc)], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
    outs = [p.communicate(timeout=60) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err[-2000:]
        assert out.split()[1] == "library"
    assert outs[0][0].split()[0] == outs[1][0].split()[0]
    assert len((build / "runs.log").read_text().split()) == 1
    assert not [f for f in os.listdir(build) if ".tmp." in f]


def test_backend_defaults(monkeypatch):
    """gloo without a card, NCCL with a card a rank, and an error (never a
    silent switch) for ranks that would share a card; a bare cuda device
    is the rank's own card."""
    from sola_torch.parallel import distributed
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert distributed.default_backend() == "gloo"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")
    monkeypatch.setenv("LOCAL_RANK", "3")
    assert distributed.default_backend() == "nccl"
    assert distributed.default_backend("cpu") == "gloo"
    assert distributed.rank_device("cuda") == torch.device("cuda", 1)
    assert distributed.rank_device("cpu") == torch.device("cpu")
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "4")
    with pytest.raises(RuntimeError, match="backend='gloo'"):
        distributed.default_backend()
    assert not distributed.initialize(num_processes=1)
