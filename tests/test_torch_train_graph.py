"""The training step's CUDA-graph path, on the CPU at tiny size: what it
changed everywhere else must not move.

* the flash attention's seed read from a tensor buffer (a view, as a
  captured step passes it) equals the integer seed, forward and backward;
* ``train_step`` on the CPU (eager) gives the losses and weights of the
  recipe before graphs, bit for bit, and leaves the host generator where
  that recipe left it: one draw for the mask generator, then one for each
  attention call with dropout, drawn one by one during the forward;
* ``set_learning_rate`` reaches AdamW, and optimizer state dicts written
  with a float or a device-style tensor learning rate load;
* the graph path is taken on a CUDA device without a mesh only.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from sola_torch.models.layers import DropoutRng
from sola_torch.models.selection import (SelectionConfig, SelectionModel,
                                         init_weights)
from sola_torch.models.text import HashTextEncoder
from sola_torch.ops import flash_attention as fa
from sola_torch.train import graphs, loop
from sola_torch.train import loss as loss_lib
from sola_torch.train import state as state_lib
from sola_torch.utils import profiling

TRAIN_CFG = {"positive_metric": "iou", "positive_threshold": 0.5,
             "temperature": 0.07, "positive_weight": 1.5,
             "alignment_weight": 0.3}


@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_seed_from_a_buffer_equals_the_integer_seed(rate):
    gen = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(2, 4, 12, 16, generator=gen, requires_grad=True)
               for _ in range(3))
    mask = torch.rand(2, 12, generator=gen) > 0.3
    seed = 2 ** 32 - 12345
    buf = torch.tensor([7, 1, 2, seed, 5], dtype=torch.int64)
    outs, grads = [], []
    for s in (buf[3:4], seed, torch.tensor([seed])):
        out = fa.fused_attention(q, k, v, key_mask=mask, dropout_rate=rate,
                                 dropout_seed=s)
        g = torch.autograd.grad((out * out).sum(), (q, k, v))
        outs.append(out.detach())
        grads.append(g)
    for out, g in zip(outs[1:], grads[1:]):
        assert torch.equal(out, outs[0])
        for a, b in zip(g, grads[0]):
            assert torch.equal(a, b)
    if rate > 0:  # the seed is read: another one drops other entries
        other = fa.fused_attention(q, k, v, key_mask=mask, dropout_rate=rate,
                                   dropout_seed=buf[4:5])
        assert not torch.equal(other, outs[0])


class _InterleavedRng:
    """The dropout streams as drawn before the graph path: the mask
    generator seeded from one host draw at the forward's start, each kernel
    seed drawn from the host when its call comes."""

    def __init__(self, generator, device):
        self.host = generator
        self.device = torch.Generator(device=device).manual_seed(
            int(torch.randint(0, 2 ** 62, (1,), generator=generator)))

    def seed(self):
        return torch.randint(0, 2 ** 32, (1,), generator=self.host)

    dropout = DropoutRng.dropout


def _model(use_flash: bool):
    cfg = SelectionConfig(n_layers=2, object_token_dim=16, lang_token_dim=32,
                          n_negative=4, dropout_p=0.2, attn_dropout_p=0.1,
                          n_groups=4, n_groups_module=4,
                          use_pallas_attention=use_flash)
    model = SelectionModel(cfg)
    init_weights(model, seed=5)
    return model


def _batches():
    text = HashTextEncoder(hidden_size=32)
    rng = np.random.default_rng(1)
    out = []
    for i in range(3):
        n, t = 5 + i, 9
        raw = {"expression": [f"the object {i} turning"],
               "object_tokens": rng.standard_normal(
                   (1, n, t, 16)).astype(np.float32),
               "track_mask": np.arange(n)[None] < n - 1,
               "frame_lengths": np.array([t - i]),
               "labels": {"iou": rng.random((1, n))}}
        out.append(loop.prepare_batch(raw, text, TRAIN_CFG, "cpu"))
    return out


def _recipe_before(model, batches, gen):
    """The step before the graph path: gradients freed each step, the
    interleaved draws, the clip and AdamW with a float learning rate."""
    params = [p for p in model.parameters() if p.requires_grad]
    adamw = torch.optim.AdamW(params, lr=1e-3, betas=(0.9, 0.999), eps=1e-8,
                              weight_decay=0.01)
    losses = []
    for batch in batches:
        model.train()
        adamw.zero_grad(set_to_none=True)
        logits, tokens = model(
            batch["object_tokens"], batch["lang_tokens"],
            track_mask=batch["track_mask"],
            frame_lengths=batch["frame_lengths"],
            lang_mask=batch["lang_mask"], deterministic=False,
            rng=_InterleavedRng(gen, "cpu"))
        loss, _ = loss_lib.total_loss(
            logits, tokens, batch["labels"], batch["pos_tokens"],
            model.get_negative_tokens(1), temperature=0.07,
            positive_weight=1.5, alignment_weight=0.3,
            track_mask=batch["track_mask"])
        loss.backward()
        grads = [p.grad for p in params]
        norm = torch.linalg.vector_norm(
            torch.stack(torch._foreach_norm(grads)).float())
        torch._foreach_mul_(grads, torch.where(norm < 1.0, 1.0, 1.0 / norm))
        adamw.step()
        losses.append(loss.detach())
    return losses


@pytest.mark.parametrize("use_flash", [True, False])
def test_cpu_steps_equal_the_recipe_before_graphs(use_flash):
    batches = _batches()
    want_model, got_model = _model(use_flash), _model(use_flash)
    want_gen = torch.Generator().manual_seed(42)
    got_gen = torch.Generator().manual_seed(42)
    want = _recipe_before(want_model, batches, want_gen)
    optimizer = state_lib.make_optimizer(got_model.parameters(), lr=1e-3,
                                         grad_clip_norm=1.0)
    got = [loop.train_step(got_model, optimizer, b, TRAIN_CFG,
                           got_gen)["total"] for b in batches]
    assert optimizer.graphs is None
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    for (name, a), b in zip(got_model.state_dict().items(),
                            want_model.state_dict().values()):
        assert torch.equal(a, b), name
    assert torch.equal(got_gen.get_state(), want_gen.get_state())
    # 1 draw for the mask generator, 1 for each of 2 x 3 attention calls
    n_calls = got_model.kernel_seed_calls()
    assert n_calls == (6 if use_flash else 0)
    replay = torch.Generator().manual_seed(42)
    for _ in batches:
        DropoutRng.draw(replay, n_calls)
    assert torch.equal(replay.get_state(), got_gen.get_state())


def test_a_forward_asking_more_seeds_than_drawn_raises():
    rng = DropoutRng(torch.zeros(3, dtype=torch.int64),
                     torch.Generator().manual_seed(0))
    assert rng.seed().tolist() == [0] and rng.seed().tolist() == [0]
    with pytest.raises(RuntimeError, match="kernel seeds"):
        rng.seed()


def _adamw_reference(lr, param, grad):
    """One AdamW step from zero moments (bias-corrected, decoupled decay)."""
    p = param * (1 - lr * 0.01)
    m, v = 0.1 * grad, 0.001 * grad * grad
    m_hat, v_hat = m / 0.1, v / 0.001
    return p - lr * m_hat / (v_hat.sqrt() + 1e-8)


def test_set_learning_rate_reaches_adamw():
    param = torch.nn.Parameter(torch.tensor([1.0, -2.0, 3.0]))
    optimizer = state_lib.make_optimizer([param], lr=1e-3,
                                         grad_clip_norm=0.0)
    state_lib.set_learning_rate(optimizer, 0.25)
    assert optimizer.adamw.param_groups[0]["lr"] == 0.25
    start = param.detach().clone()
    param.grad = torch.tensor([0.5, -1.0, 2.0])
    optimizer.step()
    want = _adamw_reference(0.25, start, torch.tensor([0.5, -1.0, 2.0]))
    assert torch.allclose(param.detach(), want, rtol=1e-6, atol=1e-7)
    assert not torch.allclose(param.detach(), _adamw_reference(
        1e-3, start, torch.tensor([0.5, -1.0, 2.0])))


@pytest.mark.parametrize("written", ["float_lr", "tensor_lr_capturable"])
def test_optimizer_state_dicts_of_either_lr_load(written):
    """A state dict from before the graph path (float lr, host step) and
    one as a capturable AdamW writes it (tensor lr, capturable) both load,
    the moments and step as written and the lr into the optimizer."""
    src = torch.nn.Parameter(torch.tensor([1.0, 2.0]))
    adamw = torch.optim.AdamW([src], lr=3e-4, weight_decay=0.01)
    src.grad = torch.tensor([0.1, -0.2])
    adamw.step()
    saved = adamw.state_dict()
    if written == "tensor_lr_capturable":
        saved["param_groups"][0].update(lr=torch.tensor(3e-4),
                                        capturable=True)
    dst = torch.nn.Parameter(torch.tensor([1.0, 2.0]))
    optimizer = state_lib.make_optimizer([dst], lr=1e-3)
    optimizer.load_state_dict(saved)
    group = optimizer.adamw.param_groups[0]
    assert group["lr"] == pytest.approx(3e-4, rel=1e-6)
    assert group["capturable"] is False
    st = optimizer.adamw.state[dst]
    assert torch.equal(st["exp_avg"], adamw.state[src]["exp_avg"])
    assert float(st["step"]) == 1.0
    state_lib.set_learning_rate(optimizer, 1e-5)
    dst.grad = torch.tensor([0.1, -0.2])
    optimizer.step()  # the loaded state steps on
    assert float(optimizer.adamw.state[dst]["step"]) == 2.0


def test_the_graph_path_is_taken_on_cuda_without_a_mesh_only():
    cuda = {"object_tokens": SimpleNamespace(is_cuda=True)}
    cpu = {"object_tokens": torch.zeros(1, 2, 3, 4)}
    mesh = SimpleNamespace(data_group=None)
    assert graphs.usable(cuda, None)
    assert not graphs.usable(cuda, mesh)
    assert not graphs.usable(cpu, None)
    assert not graphs.usable(cpu, mesh)
    # a traced CPU run counts its steps and neither captures nor replays
    model = _model(True)
    optimizer = state_lib.make_optimizer(model.parameters(), lr=1e-3)
    gen = torch.Generator().manual_seed(0)
    profiling.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        for batch in _batches()[:2]:
            loop.train_step(model, optimizer, batch, TRAIN_CFG, gen)
    counters = profiling.snapshot()["counters"]
    profiling.reset()
    assert counters == {"train.steps": 2}
    assert optimizer.graphs is None


def test_shape_keys_tell_padded_shapes_apart():
    batches = _batches()
    keys = {graphs.shape_key(b) for b in batches}
    assert len(keys) == len(batches)
    again = {k: v.clone() for k, v in batches[0].items()}
    assert graphs.shape_key(again) == graphs.shape_key(batches[0])
