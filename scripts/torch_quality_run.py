"""Quality-at-scale run of the PyTorch port through its CLIs, killed and
resumed, and held bit for bit against an unbroken run.

The port's counterpart of ``scripts/quality_run.py``, on the same synthetic
MeViS-shaped corpus (``--n_videos`` train videos x 2 expressions x 32
frames, and a held-out valid_u split) and the same YAML (the reference
widths: object tokens 256, language 1024, 2 alignment layers):

  1. ``python -m sola_torch.cli.train`` runs ``--epochs`` epochs unbroken
     into one output directory;
  2. a second run into another directory is SIGKILLed inside epoch
     ``--kill_after_epoch`` + 1: once that epoch's predecessor has its
     checkpoint and its ``log.txt`` block, so the killed epoch's work is
     thrown away as a preemption throws it away, and then relaunched with
     ``--resume`` to the end;
  3. every ``epoch_N.pth`` and ``epoch_N.resume.pth`` after the kill must be
     bit for bit the unbroken run's (each tensor's bytes; so also
     ``torch.equal``), and ``log.txt`` equal line for line;
  4. ``python -m sola_torch.cli.eval`` scores J&F at ``--eval_epochs`` and,
     with ``--threshold_sweep``, the top 3 epochs at each threshold;
  5. ``log.txt``, the metrics JSONs and ``summary.json`` (wall seconds and
     pairs/s of both runs, J&F by epoch, ``resume_bit_equal``, the text
     encoder, the card's name and power limit) go to ``--out``.

It exits nonzero when any file or log line differs, after writing the
summary. The unbroken run's checkpoints are reduced to their digests once
it ends, so the two runs' files never lie on disk together (about 0.4 GB
an epoch at the reference widths).

Usage: python scripts/torch_quality_run.py [--n_videos 120] [--epochs 15]
       [--kill_after_epoch 6] [--eval_epochs 1,8,15] [--batch_size 1]
       [--text_encoder roberta_random] [--threshold_sweep 0.2,0.3,0.4,0.5]
       [--keep_work] [--out DIR] [--device cuda]
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import time

import yaml

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

EXP = "quality_run"


def build_corpus(root: str, n_videos: int) -> dict:
    from sola_torch.data import synthetic

    # train split (with GT labels) + a held-out eval split
    ds = synthetic.generate(
        root, n_videos=n_videos, n_frames=32, n_objects=2, n_distractors=4,
        data_type="train", seed=7)
    synthetic.generate(
        root, n_videos=max(n_videos // 6, 4), n_frames=32, n_objects=2,
        n_distractors=4, data_type="valid_u", seed=1007)
    cfgs = ds["configs"]
    cfgs["valid"] = dict(cfgs["valid"], data_type="valid_u")
    cfgs["test"] = dict(cfgs["test"], data_type="valid_u")
    return ds


def write_yaml(path: str, ds: dict, out_root: str, epochs: int,
               batch_size: int = 1, model_overrides: dict = None) -> None:
    """``scripts/quality_run.py``'s configuration."""
    configs = {
        "exp_name": EXP,
        "model": {
            "object_token_dim": 256, "lang_token_dim": 1024, "n_layers": 2,
            "max_temporal_length": 100, "n_negative": 32, "dropout_p": 0.2,
            "norm_type": "group", "n_groups": 8, "n_groups_module": 8,
            **(model_overrides or {}),
        },
        "train": {
            "n_epochs": epochs, "pred_threshold": 0.5, "temperature": 0.07,
            "alignment_weight": 0.3, "lr": 1e-4, "lr_factor": 0.5,
            "lr_patience": 2, "grad_clip_norm": 1.0,
            "positive_metric": "iou", "positive_threshold": 0.7,
            "positive_weight": 1.5, "bf16_token_transfer": True,
        },
        "dataset": {k: (dict(v, batch_size=batch_size)
                        if k == "train" and isinstance(v, dict) else v)
                    for k, v in ds["configs"].items()},
        "eval": {"pred_threshold": 0.5},
        "results": {
            "output_dir": os.path.join(out_root, "TRAIN"),
            "eval_output_dir": os.path.join(out_root, "EVAL"),
            "test_output_dir": os.path.join(out_root, "INFER"),
        },
    }
    with open(path, "w") as f:
        yaml.safe_dump(configs, f)


def cli_env() -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    return env


def launch_train(yaml_path: str, out_root: str, device: str, log_path: str,
                 resume: bool = False) -> subprocess.Popen:
    """The train CLI into ``out_root``, its output to ``log_path``."""
    cmd = [sys.executable, "-m", "sola_torch.cli.train", "--config",
           yaml_path, "--device", device, "--results.output_dir", out_root]
    with open(log_path, "a") as out:
        return subprocess.Popen(cmd + (["--resume"] if resume else []),
                                env=cli_env(), stdout=out,
                                stderr=subprocess.STDOUT)


def tail(path: str, n: int = 30) -> str:
    with open(path) as f:
        return "".join(f.readlines()[-n:])


def wait_ok(proc: subprocess.Popen, log_path: str, what: str) -> None:
    if proc.wait() != 0:
        raise RuntimeError(f"{what} failed (exit {proc.returncode}):\n"
                           f"{tail(log_path)}")


def epoch_block_written(train_dir: str, epoch: int) -> bool:
    """log.txt holds epoch ``epoch``'s whole block (its last line)."""
    try:
        with open(os.path.join(train_dir, "log.txt")) as f:
            return f"VALID EPOCH {epoch:03d} | TP:" in f.read()
    except FileNotFoundError:
        return False


def digests(obj, path: str = "") -> list:
    """(path, dtype, shape, sha256 of the bytes) of every tensor in a saved
    object and (path, repr) of every other leaf, in order: two objects
    whose lists are equal are bit for bit equal."""
    import torch
    if isinstance(obj, torch.Tensor):
        t = obj.detach().cpu().contiguous()
        return [(path, str(t.dtype), tuple(t.shape), hashlib.sha256(
            t.reshape(-1).view(torch.uint8).numpy().tobytes()).hexdigest())]
    if isinstance(obj, dict):
        return [d for k in obj for d in digests(obj[k], f"{path}/{k}")]
    if isinstance(obj, (list, tuple)):
        return [d for i, x in enumerate(obj)
                for d in digests(x, f"{path}/{i}")]
    return [(path, repr(obj))]


def checkpoint_digests(train_dir: str, epochs) -> dict:
    """{file name: digests} of each epoch's weights and resume file."""
    import torch
    out = {}
    for e in epochs:
        for name in (f"epoch_{e}.pth", f"epoch_{e}.resume.pth"):
            out[name] = digests(torch.load(os.path.join(train_dir, name),
                                           map_location="cpu",
                                           weights_only=True))
    return out


def card_line(device: str) -> str:
    """The card's name and power limit as nvidia-smi gives them."""
    if not device.startswith("cuda"):
        return "cpu (no card)"
    proc = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True)
    return proc.stdout.strip().splitlines()[0]


def run_eval(yaml_path: str, out_root: str, device: str, epoch: int,
             threshold=None) -> tuple:
    """The eval CLI on ``epoch``'s weights: (its metrics JSON, its output
    dir)."""
    cmd = [sys.executable, "-m", "sola_torch.cli.eval", "--config",
           yaml_path, "--device", device, "--eval_weight_epoch", str(epoch),
           "--results.output_dir", out_root]
    if threshold is not None:
        cmd += ["--eval_pred_threshold", str(threshold)]
    proc = subprocess.run(cmd, env=cli_env(), capture_output=True,
                          text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"eval epoch {epoch} threshold {threshold}: "
                           f"{proc.stdout[-2000:]}{proc.stderr[-2000:]}")
    eval_dir = next(line.split("IN", 1)[1].strip()
                    for line in proc.stdout.splitlines()
                    if "EVAL OUTPUTS WILL BE SAVED IN" in line)
    with open(os.path.join(eval_dir,
                           f"valid_u_metrics_{epoch}epoch.json")) as f:
        return json.load(f), eval_dir


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n_videos", type=int, default=120)
    ap.add_argument("--epochs", type=int, default=15)
    ap.add_argument("--kill_after_epoch", type=int, default=6)
    ap.add_argument("--out", default=os.path.join(REPO, "artifacts",
                                                  "quality_run_torch"))
    ap.add_argument("--eval_epochs", default="1,8,15")
    ap.add_argument("--batch_size", type=int, default=1)
    ap.add_argument("--text_encoder", default=None,
                    help="e.g. roberta_random: a seeded random "
                         "RoBERTa-large in the loop instead of the hash "
                         "stand-in")
    ap.add_argument("--threshold_sweep", default="",
                    help="comma thresholds; after the per-epoch pass, the "
                         "top-3 epochs by J&F are evaluated again at each")
    ap.add_argument("--keep_work", action="store_true",
                    help="keep the work dir (corpus, checkpoints)")
    ap.add_argument("--device", default="cuda",
                    help="torch device of both CLIs")
    args = ap.parse_args(argv)
    if not 0 < args.kill_after_epoch < args.epochs:
        ap.error("--kill_after_epoch must lie inside the run")

    card = card_line(args.device)
    print(f"[quality_run] card: {card}", flush=True)
    work = tempfile.mkdtemp(prefix="torch_quality_run_")
    ds = build_corpus(work, args.n_videos)
    yaml_path = os.path.join(work, "quality_run.yaml")
    write_yaml(yaml_path, ds, work, args.epochs, args.batch_size,
               model_overrides=({"text_encoder": args.text_encoder}
                                if args.text_encoder else None))
    roots = {run: os.path.join(work, run) for run in ("unbroken", "resumed")}
    dirs = {run: os.path.join(root, EXP, "mevis")
            for run, root in roots.items()}
    logs = {run: os.path.join(work, f"{run}.out") for run in roots}
    kill = args.kill_after_epoch
    compared = range(kill + 1, args.epochs + 1)
    from sola_torch.train.state import latest_checkpoint_epoch

    # phase 1: the unbroken run, reduced to digests once it ends
    t0 = time.time()
    wait_ok(launch_train(yaml_path, roots["unbroken"], args.device,
                         logs["unbroken"]), logs["unbroken"], "unbroken run")
    unbroken_s = time.time() - t0
    print(f"[quality_run] unbroken run: {unbroken_s:.1f} s", flush=True)
    want = checkpoint_digests(dirs["unbroken"], compared)
    for name in os.listdir(dirs["unbroken"]):
        if name.endswith(".pth"):
            os.remove(os.path.join(dirs["unbroken"], name))

    # phase 2: SIGKILL inside epoch kill + 1, then --resume to the end
    t0 = time.time()
    proc = launch_train(yaml_path, roots["resumed"], args.device,
                        logs["resumed"])
    while proc.poll() is None and not epoch_block_written(dirs["resumed"],
                                                          kill):
        time.sleep(0.02)
    if proc.poll() is not None:
        raise RuntimeError(f"the run ended before the kill (exit "
                           f"{proc.returncode}):\n{tail(logs['resumed'])}")
    proc.send_signal(signal.SIGKILL)
    proc.wait()
    killed_s = time.time() - t0
    landed = latest_checkpoint_epoch(dirs["resumed"])
    leftovers = sorted(n for n in os.listdir(dirs["resumed"])
                       if n.endswith(".tmp"))
    print(f"[quality_run] SIGKILL at {killed_s:.1f} s, inside epoch {kill + 1}; "
          f"newest checkpoint epoch {landed}; unfinished saves left "
          f"{leftovers}", flush=True)
    if landed != kill:
        raise RuntimeError(f"the kill landed after epoch {landed} ended, not "
                           f"inside epoch {kill + 1}")
    t0 = time.time()
    wait_ok(launch_train(yaml_path, roots["resumed"], args.device,
                         logs["resumed"], resume=True), logs["resumed"],
            "resumed run")
    resumed_s = time.time() - t0
    with open(logs["resumed"]) as f:
        if f"resumed from epoch {kill}" not in f.read():
            raise RuntimeError("the resumed run did not restore epoch "
                               f"{kill}:\n{tail(logs['resumed'])}")
    print(f"[quality_run] resumed run: {resumed_s:.1f} s", flush=True)

    # phase 3: bit for bit against the unbroken run
    got = checkpoint_digests(dirs["resumed"], compared)
    differ = sorted(name for name in want if got[name] != want[name])
    with open(os.path.join(dirs["unbroken"], "log.txt")) as f:
        want_log = f.read().splitlines()
    with open(os.path.join(dirs["resumed"], "log.txt")) as f:
        got_log = f.read().splitlines()
    log_differ = [i + 1 for i, (a, b) in enumerate(zip(want_log, got_log))
                  if a != b]
    if len(want_log) != len(got_log):
        log_differ.append(min(len(want_log), len(got_log)) + 1)
    bit_equal = not differ and not log_differ
    print(f"[quality_run] resumed against unbroken: {len(want)} checkpoint files "
          f"compared, differing {differ}; log.txt lines differing "
          f"{log_differ}", flush=True)
    for name in os.listdir(dirs["resumed"]):
        if name.endswith(".resume.pth") or name.endswith(".tmp"):
            os.remove(os.path.join(dirs["resumed"], name))

    # phase 4: J&F through the eval CLI
    keys = ("mean_J", "mean_F", "mean_JF", "accuracy", "f1", "total_loss")
    jf_by_epoch, eval_dirs = {}, {}
    for epoch in [int(e) for e in args.eval_epochs.split(",")]:
        m, eval_dirs[epoch] = run_eval(yaml_path, roots["resumed"],
                                       args.device, epoch)
        jf_by_epoch[epoch] = {k: m[k] for k in keys}
        print(f"[eval] epoch {epoch}: {jf_by_epoch[epoch]}", flush=True)
    sweep = {}
    if args.threshold_sweep:
        top = sorted(jf_by_epoch, key=lambda e: -jf_by_epoch[e]["mean_JF"])
        for epoch in sorted(top[:3]):
            for thr in [float(t) for t in args.threshold_sweep.split(",")]:
                m, _ = run_eval(yaml_path, roots["resumed"], args.device,
                                epoch, thr)
                sweep[f"epoch{epoch}_thr{thr}"] = {
                    k: m[k] for k in ("mean_J", "mean_F", "mean_JF", "f1",
                                      "precision", "recall")}
                print(f"[sweep] epoch {epoch} thr {thr}: "
                      f"JF={m['mean_JF']:.4f} f1={m['f1']:.4f}", flush=True)

    # phase 5: artifacts
    import torch
    os.makedirs(args.out, exist_ok=True)
    shutil.copy(os.path.join(dirs["resumed"], "log.txt"),
                os.path.join(args.out, "log.txt"))
    for epoch, eval_dir in eval_dirs.items():
        for name in os.listdir(eval_dir):
            shutil.copy(os.path.join(eval_dir, name),
                        os.path.join(args.out, name))
    n_pairs = args.n_videos * 2
    summary = {
        "corpus": {"n_videos": args.n_videos, "expressions_per_video": 2,
                   "n_train_pairs": n_pairs, "n_frames": 32,
                   "tracks_per_video": 6},
        "epochs": args.epochs,
        "batch_size": args.batch_size,
        "killed_after_epoch": kill,
        "kill": {"at_s": killed_s, "inside_epoch": kill + 1,
                 "newest_checkpoint_after_kill": landed,
                 "unfinished_saves_left": leftovers},
        "resume_bit_equal": bit_equal,
        "compared": {"checkpoint_files": sorted(want),
                     "differing_files": differ,
                     "log_lines": len(want_log),
                     "differing_log_lines": log_differ},
        "unbroken_train_wall_s": unbroken_s,
        "unbroken_train_pairs_per_s": n_pairs * args.epochs / unbroken_s,
        "killed_and_resumed_train_wall_s": killed_s + resumed_s,
        "killed_and_resumed_train_pairs_per_s":
            n_pairs * args.epochs / (killed_s + resumed_s),
        "jf_by_epoch": jf_by_epoch,
        "device": args.device,
        "card": card,
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "text_encoder": args.text_encoder or "hash (no local weights)",
    }
    if sweep:
        summary["threshold_sweep"] = sweep
        peak_key = max(sweep, key=lambda k: sweep[k]["mean_JF"])
        summary["peak"] = {"config": peak_key, **sweep[peak_key]}
    with open(os.path.join(args.out, "summary.json"), "w") as f:
        json.dump(summary, f, indent=2)
    print(json.dumps(summary, indent=2))
    if args.keep_work:
        print(f"work dir kept: {work}")
    else:
        shutil.rmtree(work, ignore_errors=True)
    if not bit_equal:
        print("QUALITY RUN FAILED: the resumed run differs from the unbroken "
              "run")
        return 1
    final_jf = jf_by_epoch[max(jf_by_epoch)]["mean_JF"]
    print(f"QUALITY RUN OK: resumed run bit-equal to the unbroken run; J&F "
          f"{final_jf:.4f} at epoch {max(jf_by_epoch)}; artifacts in "
          f"{args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
