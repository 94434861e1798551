"""Entry ``train_select``: selection training at batch 1, one
``prepare_batch`` + ``train_step`` after another, in ``train/loop.py``'s
order over the port's dataset, loader and device token cache, inside
``deterministic_cudnn`` as ``train`` runs. No validation, no checkpoint.

Set-up writes the mix's corpus, draws the selector's and RoBERTa-large's
weights from the seed, builds the model, the caching text encoder and the
optimizer, and passes once over the loader without training, which fills
the text cache, the dataset's host sample cache and the device token
cache: the window stands for epochs 2-15 of the reference's 15, which
find them full. It then runs each padded shape the corpus can give once
forward and backward without a step (throwaway gradients), and takes the
first ``SETUP_STEPS`` training steps through the window's own calls. A unit
of the window is one step: the loader's next batch and ``prepare_batch``
(span ``data``), then ``train_step``, ended by a synchronize.

The plain reference follows the set-up's steps and the window's first
``COMPARED_STEPS`` from the seed. Compared: every one of those steps'
losses, the gradient of the window's first step as AdamW took it (worked
out from its first moments before and after), and each leaf's change over
the window's compared steps.
"""

from __future__ import annotations

import shutil
import time

import numpy as np

from benchmark.core import device as device_lib
from benchmark.core import env, window
from benchmark.gen import mevis_corpus

TRACK_BUCKETS = (8, 16, 32, 64, 96, 128)
FRAME_BUCKETS = (16, 32, 64, 128, 256, 512)
SETUP_STEPS = 3
COMPARED_STEPS = 3
BETA1 = 0.9     # AdamW's first-moment decay in the program and the reference


def _round_up(x, buckets):
    return next((b for b in buckets if x <= b), buckets[-1])


def _snapshot(tensors: dict) -> dict:
    """Copies of same-typed tensors on their device through one
    concatenation: one kernel in a timed step, not a copy a leaf, and no
    wait for the host."""
    import torch
    flat = torch.cat([t.detach().reshape(-1) for t in tensors.values()])
    parts = flat.split([t.numel() for t in tensors.values()])
    return {n: x.view(t.shape) for (n, t), x in zip(tensors.items(), parts)}


def _host(tensors: dict) -> dict:
    return {n: t.cpu() for n, t in tensors.items()}


def leaf_gap(got: dict, ref: dict, keep=None) -> tuple:
    """The widest gap between the two sides' norms of a leaf, over the
    reference's norm of that leaf or of the median leaf, whichever is
    larger; (gap, leaf)."""
    import torch
    names = [n for n in ref if keep is None or n in keep]
    rn = {n: float(torch.linalg.vector_norm(ref[n].double())) for n in names}
    gn = {n: float(torch.linalg.vector_norm(got[n].double())) for n in names}
    med = float(np.median(list(rn.values())))
    worst = max(names, key=lambda n: abs(gn[n] - rn[n]) / max(rn[n], med,
                                                              1e-30))
    return abs(gn[worst] - rn[worst]) / max(rn[worst], med, 1e-30), worst


def compare(got: dict, ref: dict) -> dict:
    """Readings of the compared steps: each step's loss against the
    reference's (relative, widest), the window's first gradient as the
    optimizer got it (per leaf, widest), and each leaf's change over the
    window's compared steps (per leaf, widest), leaving out leaves whose
    reference gradient is under a thousandth of the median leaf's (they
    move by round-off)."""
    import torch
    loss = max(abs(g - r) / max(abs(r), 1e-30)
               for g, r in zip(got["losses"], ref["losses"]))
    grad, grad_leaf = leaf_gap({n: g.cpu() for n, g in got["grads"].items()},
                               {n: g.cpu() for n, g in ref["grads"].items()})
    gnorm = {n: float(torch.linalg.vector_norm(g.double()))
             for n, g in ref["grads"].items()}
    med = float(np.median(list(gnorm.values())))
    keep = {n for n, v in gnorm.items() if v >= 1e-3 * med}
    d_got = {n: got["params"][n].double().cpu()
             - got["start"][n].double().cpu() for n in keep}
    d_ref = {n: ref["params"][n].double().cpu()
             - ref["start"][n].double().cpu() for n in keep}
    update, update_leaf = leaf_gap(d_got, d_ref)
    return {"loss_gap": float(loss), "grad_gap": float(grad),
            "update_gap": float(update), "grad_leaf": grad_leaf,
            "update_leaf": update_leaf, "leaves_left_out": len(gnorm) - len(keep)}


class Cell:
    def __init__(self, record, size: str = "large", device: str = "cuda"):
        self.record = record
        self.size = size
        self.device = device
        self.params = record.cell["params"]
        self.root = env.scratch_dir(f"{record.workload}.{record.seed}")

    # ------------------------------------------------------------------
    def setup(self) -> None:
        import torch

        from benchmark.models import sola_selection_mevis as weights
        from sola_torch.data.dataset import get_loader_dict
        from sola_torch.data.device_cache import make_token_cache
        from sola_torch.models.selection import (SelectionConfig,
                                                 SelectionModel)
        from sola_torch.models.text import (CachingTextEncoder,
                                            RobertaConfig, RobertaEncoder,
                                            TextEncoder)
        from sola_torch.ops import kernel_build
        from sola_torch.train import loop
        from sola_torch.train import state as state_lib
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        shutil.rmtree(self.root, ignore_errors=True)
        t = time.perf_counter()
        self.setup_s = {}

        def lap(name):
            nonlocal t
            now = time.perf_counter()
            self.setup_s[name] = now - t
            t = now

        if self.device == "cuda":
            kernel_build.build_all()
        lap("kernels")
        rec, cfg = self.record, self.record.config
        self.corpus = mevis_corpus.generate(self.root, rec.mix, rec.seed)
        lap("traffic")
        self.train_cfg = dict(cfg["train"])

        model_cfg = dict(cfg["model"])
        if self.size != "large":
            model_cfg.update(cfg["tiny_model"])
        with torch.device("meta"):
            model = SelectionModel(SelectionConfig.from_dict(model_cfg))
            roberta = RobertaEncoder(RobertaConfig.large()
                                     if self.size == "large"
                                     else RobertaConfig.tiny())
        model.load_state_dict(weights.selection_state_dict(
            cfg, rec.seed, self.device, self.size), assign=True)
        roberta.load_state_dict(weights.roberta_state_dict(
            rec.seed, self.device, self.size), assign=True)
        self.model = model
        lap("weights")
        self.text = CachingTextEncoder(TextEncoder(roberta))
        texts = [e["exp"] for v in self.corpus["videos"].values()
                 for e in v["expressions"].values()]
        for i in range(0, len(texts), 64):
            self.text.encode_batch(texts[i:i + 64])
        lap("text_cache")
        self.optimizer = state_lib.make_optimizer(
            model.parameters(), lr=float(self.train_cfg["lr"]),
            grad_clip_norm=float(self.train_cfg["grad_clip_norm"]))
        dataset = dict(self.corpus["dataset"])
        dataset["valid"] = dict(dataset["train"])
        self.loader = get_loader_dict(dataset)["train"]
        self.token_cache = make_token_cache(
            dataset["train"], dtype=torch.float32, device=self.device)
        self.loader.materialize_tokens = False
        for raw in self.loader:     # epoch 1's reads, no step
            self.token_cache.batch_tokens(raw)
        lap("data_caches")
        self.generator = torch.Generator().manual_seed(
            int(rec.seed) % (1 << 63))
        self._cudnn = loop.deterministic_cudnn()
        self._cudnn.__enter__()
        self._iter = iter(self.loader)
        self.warm_shapes()
        lap("warm_shapes")
        self.samples, self.losses, self.snap = [], [], {}
        for i in range(SETUP_STEPS):
            self.step(i, spans=False)
        self.snap["start"] = _host(self._params())
        self.snap["start_exp_avg"] = _host(self._exp_avg())
        lap("first_steps")

    def _params(self) -> dict:
        return _snapshot(dict(self.model.named_parameters()))

    def _exp_avg(self) -> dict:
        """AdamW's first moments: zeros for a parameter the optimizer never
        stepped."""
        import torch
        names = {id(p): n for n, p in self.model.named_parameters()}
        st = self.optimizer.adamw.state
        return _snapshot({
            names[id(p)]: (st[p]["exp_avg"] if "exp_avg" in st.get(p, {})
                           else torch.zeros_like(p))
            for p in self.optimizer.params})

    def warm_shapes(self) -> None:
        """Each padded shape the mix can give, forward and backward once
        with a throwaway generator; the gradients are dropped."""
        import torch

        from sola_torch.train import loop
        mix = self.record.mix
        nbs = sorted({_round_up(int(n), TRACK_BUCKETS) for n in mix["tracks"]})
        tbs = sorted({_round_up(int(t), FRAME_BUCKETS) for t in mix["frames"]})
        d = self.model.cfg.object_token_dim
        text = next(iter(self.corpus["videos"].values()))
        expr = next(iter(text["expressions"].values()))["exp"]
        lang, lang_mask, pos = self.text.encode_batch([expr])
        gen = torch.Generator().manual_seed(1)
        for nb in nbs:
            for tb in tbs:
                batch = {
                    "object_tokens": torch.randn(1, nb, tb, d,
                                                 device=self.device),
                    "track_mask": torch.arange(nb, device=self.device)[None]
                    < max(nb // 2, 1),
                    "frame_lengths": torch.tensor([tb - 3],
                                                  device=self.device),
                    "lang_tokens": lang, "lang_mask": lang_mask,
                    "pos_tokens": pos,
                    "labels": torch.zeros(1, nb, device=self.device)}
                self.model.train()
                _, loss, _ = loop._losses(self.model, batch, self.train_cfg,
                                          gen)
                loss.backward()
                self.optimizer.zero_grad()

    def _next_raw(self):
        try:
            return next(self._iter)
        except StopIteration:
            self._iter = iter(self.loader)
            return next(self._iter)

    def step(self, i: int, spans: bool = True) -> dict:
        import contextlib

        from sola_torch.train import loop
        span = (self.record.span if spans
                else lambda name: contextlib.nullcontext())
        with span("data"):
            raw = self._next_raw()
            batch = loop.prepare_batch(raw, self.text, self.train_cfg,
                                       self.device, self.token_cache)
        metrics = loop.train_step(self.model, self.optimizer, batch,
                                  self.train_cfg, self.generator)
        if len(self.samples) < SETUP_STEPS + COMPARED_STEPS:
            # a compared step: its pair, its loss, and in the window AdamW's
            # first moments after its first step and the weights after its
            # last, all kept on the card and read after the window
            self.samples.append((raw["video_id"][0],
                                 raw["expression_id"][0]))
            self.losses.append(metrics["total"].detach())
            done = len(self.samples) - SETUP_STEPS
            if done == 1:
                self.snap["exp_avg"] = self._exp_avg()
            if done == COMPARED_STEPS:
                self.snap["params"] = self._params()
        n = int(raw["n_tracks"][0])
        t = int(raw["frame_lengths"][0])
        return {"pairs": len(raw["video_id"]), "tracks": n, "frames": t,
                "shape": tuple(int(x) for x in
                               raw["object_token_rows"][0].shape[:2]),
                "words": int(batch["lang_mask"].sum())}

    def unit(self, i: int) -> dict:
        return self.step(i)

    # ------------------------------------------------------------------
    def program_outputs(self) -> dict:
        m0, m1 = self.snap["start_exp_avg"], _host(self.snap["exp_avg"])
        return {"losses": [float(x) for x in self.losses],
                "grads": {n: (m1[n] - BETA1 * m0[n]) / (1.0 - BETA1)
                          for n in m1},
                "start": self.snap["start"],
                "params": _host(self.snap["params"])}

    def reference_outputs(self, lower: bool = False) -> dict:
        from benchmark.models import sola_selection_mevis as weights
        from benchmark.reference import train_select as ref
        rec, cfg = self.record, self.record.config
        thr = float(cfg["train"]["positive_threshold"])
        samples = [ref.sample(self.corpus["videos"][v], e, thr)
                   for v, e in self.samples]
        return ref.run_steps(
            weights.selection_state_dict(cfg, rec.seed, self.device,
                                         self.size),
            weights.roberta_state_dict(rec.seed, self.device, self.size),
            cfg, samples, int(rec.seed) % (1 << 63), SETUP_STEPS,
            self.device, self.size, lower=lower)

    def free_program(self) -> None:
        self._cudnn.__exit__(None, None, None)
        self.model = self.optimizer = self.text = self.token_cache = None
        self.snap = None
        self.loader = self._iter = None
        if self.device == "cuda":
            device_lib.free_cuda()

    def cleanup(self) -> None:
        shutil.rmtree(self.root, ignore_errors=True)


def add_counts(record, size: str = "large") -> None:
    """Each step's operations and its attention's least time (forward and
    backward), from the configuration and the step's shapes."""
    from benchmark.counts import peaks, sola_selection_mevis as counts
    for u in record.units:
        w = counts.step_work(record.config, u["shape"], u["tracks"],
                             u["frames"], u["words"], size)
        u["flops"] = w["flops"]
        u["attention_least_s"] = sum(peaks.bound_seconds(f, b, dt)
                                     for f, b, dt in w["attention"])


def run(record, seconds: float, trace: bool, t_start: float) -> dict:
    cell = Cell(record)
    cell.setup()
    setup_s = time.time() - t_start
    window.run(record, seconds, cell.unit, trace=trace,
               trace_units=int(record.cell.get("trace_units", 50)),
               min_units=COMPARED_STEPS)
    steps_ms = [1e3 * (u["t1"] - u["t0"]) for u in record.units]
    pairs = record.total("pairs")
    e2e = {"train_pairs_per_s": pairs / record.window_seconds(),
           "setup_s": setup_s}
    dev = device_lib.info(1)
    record.memory_peak_bytes = dev["memory_peak_bytes"]
    add_counts(record)

    got = cell.program_outputs()
    cell.free_program()
    ref = cell.reference_outputs()
    readings = compare(got, ref)
    limits = record.config["limits"]["train_select"]
    checks = [device_lib.check(k, readings[k], float(limits[k]))
              for k in limits]
    cell.cleanup()
    notes = ["set-up s: " + ", ".join(f"{k} {v:.3f}"
                                      for k, v in cell.setup_s.items()),
             f"steps compared (set-up, window): {cell.samples}; worst "
             f"gradient leaf {readings['grad_leaf']}, worst update leaf "
             f"{readings['update_leaf']}, {readings['leaves_left_out']} "
             "leaves left out of the update",
             f"window {record.window_seconds():.3f} s, {len(record.units)} "
             f"steps, {pairs} pairs, median step "
             f"{float(np.median(steps_ms)):.3f} ms, 95th percentile "
             f"{window.percentile(steps_ms, 95):.3f} ms",
             f"card: {device_lib.power_limit()}"]
    return {"end_to_end": e2e, "attempted": len(record.units), "failed": 0,
            "device": dev, "checks": checks, "notes": notes}


def readings(record, control: bool) -> dict:
    """One seed's readings at the cell's size: the program's set-up and
    first window steps against the reference, and with ``control`` the
    reference in lower precision, put in the program's place, against the
    reference."""
    cell = Cell(record)
    cell.setup()
    window.run(record, 0.0, cell.unit, min_units=COMPARED_STEPS)
    got = cell.program_outputs()
    cell.free_program()
    ref = cell.reference_outputs()
    out = {"program": compare(got, ref),
           "losses": got["losses"], "ref_losses": ref["losses"]}
    if control:
        low = cell.reference_outputs(lower=True)
        out["control"] = compare(low, ref)
    cell.cleanup()
    return out
