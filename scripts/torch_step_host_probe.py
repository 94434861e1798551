"""Host time of one SAM2 propagation step, with and without a profiler.

    python scripts/torch_step_host_probe.py [--root CHECKOUT]

On a CUDA card: SAM2 hiera-L (seeded random weights), obj_batch 4, one
48-frame 480x854 video with 16 prompts on frames 0, 4, 8 and 12 (the
layout of the grid_dense traffic), tracked by ``engine.generate_tracks``
five times: a warm-up, then with no profiler, under a CPU-only
torch.profiler, under a CPU + CUDA torch.profiler (CUPTI), and with no
profiler again. Each run reports its tracking seconds, its tracks, its
steps and the mean host time of a step: the wall time of
``TrackStep.step``, the span ``trackgen.step`` reads (a checkout whose
predictor still has ``SAM2VideoPredictor._track_frame`` times that
instead). ``--root`` runs the code of another checkout (default: this
one's). Prints one JSON object as its last line.
"""

import argparse
import json
import os
import sys
import time

HW = (480, 854)
T = 48


def frames(seed):
    import numpy as np
    rng = np.random.default_rng(seed)
    out = []
    for i in range(T):
        f = rng.integers(0, 80, HW + (3,), dtype=np.uint8)
        x = 40 + 12 * i
        f[100:220, x:x + 120] = 220
        out.append(f)
    return out


def prompts(engine):
    import numpy as np
    out = []
    for fr in (0, 4, 8, 12):
        for k in range(4):
            m = np.zeros(HW, np.uint8)
            m[20 + 100 * k:90 + 100 * k, 60 * fr:60 * fr + 150] = 1
            out.append(engine.PromptMask(prompt_id=len(out), frame_idx=fr,
                                         segmentation=m))
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    root = os.path.abspath(ap.parse_args().root)
    sys.path.insert(0, root)
    os.chdir(root)

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from sola_torch.ops import kernel_build
    from sola_torch.trackgen import engine
    from sola_torch.trackgen.sam2.convert import load_sam2_video_predictor
    from sola_torch.trackgen.sam2.model import SAM2Config

    kernel_build.build_all()
    pred = load_sam2_video_predictor(None, obj_batch=4,
                                     cfg=SAM2Config.large(), device="cuda",
                                     seed=1)
    state = pred.init_state(frames(0))
    try:
        from sola_torch.trackgen.sam2.track_step import TrackStep as cls
        name = "step"
    except ImportError:
        from sola_torch.trackgen.sam2.video import SAM2VideoPredictor as cls
        name = "_track_frame"
    orig = getattr(cls, name)
    times = []

    def timed(*a, **k):
        t0 = time.perf_counter()
        out = orig(*a, **k)
        times.append(time.perf_counter() - t0)
        return out
    setattr(cls, name, timed)

    def run():
        times.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        c = engine.generate_tracks(pred, state, prompts(engine), n_frames=T,
                                   batch_size=4, miou_thresh=0.99,
                                   n_max_tracks=16)
        torch.cuda.synchronize()
        return {"track_s": time.perf_counter() - t0,
                "n_tracked": c["n_tracked"], "steps": len(times),
                "step_host_ms": 1e3 * float(np.mean(times))}

    out = {"warm": run(), "none": run()}
    with profile(activities=[ProfilerActivity.CPU]):
        out["cpu_profiler"] = run()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        out["cuda_profiler"] = run()
    out["none_again"] = run()
    print(json.dumps({"checkout": root, "timed": f"{cls.__name__}.{name}",
                      "card": torch.cuda.get_device_name(), **out}))


if __name__ == "__main__":
    main()
