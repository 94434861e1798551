"""One rank of tests/test_torch_parallel.py's process group (gloo, CPU).

    python tests/torch_parallel_worker.py WORKDIR RANK WORLD PORT

Reads WORKDIR/inputs.npz and WORKDIR/train.json (written by the test's
fixture) and runs, on a 2 x 2 (data, model) mesh of 4 ranks: a dp x tp
train step by each attention route (and once more with out_proj's forward
sum planted away), a data-parallel eval forward, cp_attention over key
shards, all_sum over shard_for_host's shares, a 2-epoch ``train()`` with
a resumed twin and a sharded ``Evaluator``. Rank 0 writes what the test
compares to WORKDIR/out.npz.
"""

import json
import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from sola_torch.models.selection import SelectionConfig  # noqa: E402
from sola_torch.models.text import HashTextEncoder  # noqa: E402
from sola_torch.parallel import cp, distributed, tp  # noqa: E402
from sola_torch.parallel.mesh import (make_mesh, reduce_sum,  # noqa: E402
                                      shard_batch)
from sola_torch.train import loop  # noqa: E402
from sola_torch.train import state as state_lib  # noqa: E402

TINY = dict(object_token_dim=16, lang_token_dim=64, n_negative=4,
            dropout_p=0.0, attn_dropout_p=0.0, n_groups=4, n_groups_module=4)
TRAIN_CFG = {"positive_weight": 1.5, "alignment_weight": 0.3,
             "temperature": 0.07}


def _state(inputs, prefix):
    return {k[len(prefix):]: torch.from_numpy(inputs[k])
            for k in inputs.files if k.startswith(prefix)}


def _batch(inputs, prefix):
    return {k[len(prefix):]: inputs[k] for k in inputs.files
            if k.startswith(prefix)}


def train_step_case(inputs, mesh, use_flash: bool,
                    dropout: bool = False) -> tuple:
    """One clipped AdamW step of the tiny 2-layer model on this rank's rows
    of the batch (with ``dropout``, the reference config's rates drawn
    from the loop's epoch-0 generator): (global loss, the gathered full
    state dict, this rank's model)."""
    rates = dict(dropout_p=0.2, attn_dropout_p=0.1) if dropout else {}
    cfg = SelectionConfig(n_layers=2, use_pallas_attention=use_flash,
                          **{**TINY, **rates})
    model = loop.build_model(cfg, "cpu", group=mesh.model_group)
    model.load_state_dict(tp.shard_state_dict(
        _state(inputs, "sd2/"), mesh.n_model, mesh.model_index))
    dims = tp.split_dims(dict(model.named_parameters()))
    optimizer = state_lib.make_optimizer(
        model.parameters(), lr=1e-3, grad_clip_norm=1.0,
        split=[dims[n] is not None for n, _ in model.named_parameters()],
        group=mesh.model_group)
    raw = _batch(inputs, "step/")
    raw["expression"] = [""] * len(raw["labels"])
    rows = shard_batch(mesh, raw)
    batch = {k: torch.from_numpy(v) for k, v in rows.items()
             if k != "expression"}
    metrics = loop.train_step(model, optimizer, batch, TRAIN_CFG,
                              loop.epoch_generator(0, mesh), mesh)
    loss = reduce_sum(metrics["total"].clone(), mesh.data_group)
    return float(loss), tp.gather_state_dict(model.state_dict(),
                                             mesh.model_group), model


def eval_case(inputs, mesh) -> torch.Tensor:
    """The 1-layer model's score map over this data rank's rows, gathered
    in row order."""
    cfg = SelectionConfig(n_layers=1, **TINY)
    model = loop.build_model(cfg, "cpu", group=mesh.model_group)
    model.load_state_dict(tp.shard_state_dict(
        _state(inputs, "sd1/"), mesh.n_model, mesh.model_index))
    raw = _batch(inputs, "eval/")
    raw["expression"] = [""] * len(raw["obj"])
    rows = shard_batch(mesh, raw)
    model.eval()
    with torch.no_grad():
        score, _ = model(torch.from_numpy(rows["obj"]),
                         torch.from_numpy(rows["lang"]))
    full = torch.zeros((len(raw["obj"]),) + score.shape[1:])
    per = score.shape[0]
    full[mesh.data_index * per:(mesh.data_index + 1) * per] = score
    return reduce_sum(full, mesh.data_group)


def main() -> None:
    workdir, rank, world, port = (sys.argv[1], int(sys.argv[2]),
                                  int(sys.argv[3]), sys.argv[4])
    torch.set_num_threads(1)
    distributed.initialize(f"127.0.0.1:{port}", world, rank, "gloo")
    inputs = np.load(os.path.join(workdir, "inputs.npz"))
    out = {}

    # all_sum over each process's shard_for_host share
    mine = distributed.shard_for_host(list(range(23)))
    summed = distributed.all_sum({"n": len(mine), "total": sum(mine)})
    out["all_sum"] = np.array([summed["n"], summed["total"]])

    mesh = make_mesh(n_model=2)
    for route, flash in (("plain", False), ("flash", True)):
        loss, state, _ = train_step_case(inputs, mesh, flash)
        out[f"step_{route}/loss"] = np.array(loss)
        out.update({f"step_{route}/{k}": v.numpy() for k, v in state.items()})
    honest = tp.reduce_from_model
    tp.reduce_from_model = lambda x, group: x  # out_proj's sum planted away
    try:
        loss, state, _ = train_step_case(inputs, mesh, False)
    finally:
        tp.reduce_from_model = honest
    out["step_fault/loss"] = np.array(loss)
    out.update({f"step_fault/{k}": v.numpy() for k, v in state.items()})

    # with dropout: every rank's replicated parameters after the step, and
    # each rank's first draws from its epoch generator
    _, _, model = train_step_case(inputs, mesh, False, dropout=True)
    dims = tp.split_dims(model.state_dict())
    replicated = torch.cat([v.reshape(-1) for k, v in
                            model.state_dict().items() if dims[k] is None])
    draws = torch.rand(64, generator=loop.epoch_generator(0, mesh))
    every = [None] * world
    torch.distributed.all_gather_object(every, (replicated.numpy(),
                                                draws.numpy()))
    out["dropout/replicated"] = np.stack([r for r, _ in every])
    out["dropout/draws"] = np.stack([d for _, d in every])

    out["eval/score"] = eval_case(inputs, make_mesh(n_data=4)).numpy()

    for case in ("ragged", "nomask", "flash", "allmasked",
                 "allmasked_flash"):
        q, k, v = (torch.from_numpy(inputs[f"cp_{case}/{n}"])
                   for n in ("q", "k", "v"))
        mask = (torch.from_numpy(inputs[f"cp_{case}/mask"])
                if f"cp_{case}/mask" in inputs.files else None)
        k, v, mask = cp.shard_keys(k, v, mask, None if world == 1 else
                                   torch.distributed.group.WORLD)
        out[f"cp_{case}"] = cp.cp_attention(
            q, k, v, mask, torch.distributed.group.WORLD,
            use_flash=case.endswith("flash")).numpy()

    spec = json.load(open(os.path.join(workdir, "train.json")))
    text = HashTextEncoder(hidden_size=64, vocab_size=128,
                           table=inputs["hash_table"])
    for name, epochs in (("straight", [2]), ("resumed", [1, 2])):
        for i, n in enumerate(epochs):
            cfg = json.loads(json.dumps(spec["configs"]))
            cfg["results"]["output_dir"] = os.path.join(workdir, name)
            cfg["train"]["n_epochs"] = n
            loop.train(cfg, max_steps_per_epoch=2, text_encoder=text,
                       log_fn=lambda *a: None, resume=i > 0, device="cpu")
    torch.distributed.barrier()

    from sola_torch.eval.evaluator import Evaluator
    cfg = json.loads(json.dumps(spec["configs"]))
    model = loop.build_model(SelectionConfig.from_dict(cfg["model"]), "cpu",
                             init_weights_path=spec["eval_weights"])
    Evaluator(model, cfg, 2, text_encoder=text,
              eval_output_dir=os.path.join(workdir, "eval")).evaluate()

    if rank == 0:
        np.savez(os.path.join(workdir, "out.npz"), **out)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
