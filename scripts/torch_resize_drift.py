"""How far the port's frame resize drifts from the JAX package's, and what
that does to the automatic mask generator's keep decisions. CPU only; needs
both packages (jax and torch).

    JAX_PLATFORMS=cpu python scripts/torch_resize_drift.py [--frames 24]

Both image predictors resize a frame to the model size with an
antialiased linear resize and truncate it to uint8. Where the frame
downscales on an axis, the two resizes round differently in their last
bits, and the truncation turns that into one gray level on some pixels.
The script reports:

- ``weights``: for each (input, output) length, how many entries of
  jax.image.resize's weight matrix (read off by resizing an identity) differ
  from the port's (resize_bilinear on the same identity) and from the
  formula jax.image.resize states, evaluated in IEEE fp32 (numpy);
- ``pixels``: the uint8 values that differ between the two
  packages' resized frames at the test size (48x72 -> 64), at Ref-YTVOS's
  720x1280 -> 1024 and at MeViS's 480x854 -> 1024 (upscaled), on frames
  of flat rectangles over noise, as the tests draw them;
- ``keep``: the tiny SAM2 (image size 64, fp32, the same weights in both
  packages) proposing over an 8x8 grid on ``--frames`` frames 48x72 and
  48x64: the largest IoU and stability differences, and the share of
  proposals whose keep decision differs between the packages, at the
  reference gates (IoU 0.8, stability 0.95) and at gates on the quartiles
  of JAX's own scores.

Prints one JSON object as its last line.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from sola_torch.core.mask_ops import resize_bilinear  # noqa: E402

S = 64


def jax_weights(m: int, n: int) -> np.ndarray:
    f = jax.jit(lambda x: jax.image.resize(x, (m, n), method="linear"))
    return np.asarray(f(jnp.eye(m, dtype=jnp.float32)))


def port_weights(m: int, n: int) -> np.ndarray:
    return resize_bilinear(torch.eye(m), (m, n)).numpy()


def formula_weights(m: int, n: int) -> np.ndarray:
    """jax.image.resize's triangle weights (compute_weight_mat), in IEEE
    fp32 with sequential sums: (m, n), row i the input, column j the
    output."""
    f32 = np.float32
    inv = f32(m / n)
    ks = max(inv, f32(1))
    sf = (np.arange(n, dtype=f32) + f32(0.5)) * inv - f32(0.5)
    x = np.abs(sf[None] - np.arange(m, dtype=f32)[:, None]) / ks
    w = np.maximum(f32(0), f32(1) - np.abs(x))
    tot = np.zeros(n, f32)
    for row in w:
        tot = tot + row
    w = np.where(np.abs(tot) > f32(1000 * np.finfo(np.float32).eps),
                 w / np.where(tot != 0, tot, f32(1)), f32(0))
    ok = (sf >= -0.5) & (sf <= f32(m - 0.5))
    return np.where(ok[None], w, f32(0)).astype(f32)


def make_frame(h: int, w: int, seed: int) -> np.ndarray:
    """Flat rectangles over noise, scaled from the tests' 48 x w frames."""
    rng = np.random.default_rng(seed)
    f = (rng.random((h, w, 3)) * 50).astype(np.uint8)
    for _ in range(4):
        y0, x0 = rng.integers(0, h // 2), rng.integers(0, w // 2)
        f[y0:y0 + rng.integers(h // 8, h // 2),
          x0:x0 + rng.integers(w // 8, w // 2)] = rng.integers(0, 256, 3)
    return f


def jax_resize(raw: np.ndarray, s: int) -> np.ndarray:
    f = jax.jit(lambda r: jax.image.resize(
        r.astype(jnp.float32), (s, s, 3), method="linear").astype(jnp.uint8))
    return np.asarray(f(raw))


def port_resize(raw: np.ndarray, s: int) -> np.ndarray:
    x = torch.from_numpy(raw).permute(2, 0, 1).float()[None]
    return resize_bilinear(x, (s, s))[0].permute(1, 2, 0).to(
        torch.uint8).numpy()


def weight_report() -> list:
    rows = []
    for m, n in ((72, 64), (1280, 1024), (720, 1024), (854, 1024),
                 (480, 1024)):
        jw = jax_weights(m, n)
        pw = port_weights(m, n)
        fw = formula_weights(m, n)
        rows.append({"in": m, "out": n, "entries": int(jw.size),
                     "jax_vs_port": int((jw != pw).sum()),
                     "jax_vs_formula": int((jw != fw).sum()),
                     "port_vs_formula": int((pw != fw).sum())})
    return rows


def pixel_report() -> list:
    rows = []
    for (h, w), s in (((48, 72), 64), ((720, 1280), 1024),
                      ((480, 854), 1024)):
        diff, most = 0, 0
        for seed in range(3):
            raw = make_frame(h, w, seed)
            a = jax_resize(raw, s).astype(np.int32)
            b = port_resize(raw, s).astype(np.int32)
            diff += int((a != b).sum())
            most = max(most, int(np.abs(a - b).max()))
        rows.append({"frame": f"{h}x{w}", "model": s,
                     "values": 3 * s * s * 3, "values_differing": diff,
                     "share_differing": diff / (3 * s * s * 3),
                     "largest_gray_levels": most})
    return rows


def keep_report(n_frames: int) -> list:
    from sola_torch.trackgen.sam2 import image as timage
    from sola_torch.trackgen.sam2.convert import state_dict_from_jax_params
    from sola_torch.trackgen.sam2.model import SAM2Config, SAM2Model
    from sola_tpu.trackgen.sam2.amg import build_point_grid
    from sola_tpu.trackgen.sam2.image import SAM2ImagePredictor as JImage
    from sola_tpu.trackgen.sam2.model import SAM2Config as JConfig
    from sola_tpu.trackgen.sam2.model import SAM2Model as JModel
    torch.set_num_threads(2)
    jmodel = JModel(JConfig.tiny_test(image_size=S))
    variables = jax.jit(jmodel.init)(jax.random.PRNGKey(1),
                                     jnp.zeros((1, S, S, 3), jnp.float32))
    variables = jax.tree_util.tree_map(np.asarray, variables)
    cfg = SAM2Config.tiny_test(image_size=S)
    model = SAM2Model(cfg)
    model.load_state_dict(state_dict_from_jax_params(variables, cfg),
                          strict=True)
    preds = (JImage(jmodel, variables, compute_dtype=jnp.float32),
             timage.SAM2ImagePredictor(model, compute_dtype=torch.float32))
    rows = []
    for w in (72, 64):
        pts = build_point_grid(8) * np.asarray([w, 48], np.float32)
        scores = []
        for t in range(n_frames):
            frame = make_frame(48, w, 100 + t)
            got = []
            for pred in preds:
                pred.set_image(frame)
                iou, stab, _ = pred.propose(pts[:, None])
                got.append((np.asarray(iou).ravel(),
                            np.asarray(stab).ravel()))
            scores.append(got)
        ji = np.concatenate([s[0][0] for s in scores])
        js = np.concatenate([s[0][1] for s in scores])
        ti = np.concatenate([s[1][0] for s in scores])
        ts = np.concatenate([s[1][1] for s in scores])
        gates = {"reference 0.8 / 0.95": (0.8, 0.95)}
        for q in (0.25, 0.5, 0.75):
            gates[f"JAX quantile {q}"] = (float(np.quantile(ji, q)),
                                          float(np.quantile(js, q)))
        flips = {}
        for name, (gi, gs) in gates.items():
            jkeep = (ji > gi) & (js > gs)
            tkeep = (ti > gi) & (ts > gs)
            flips[name] = {"iou_gate": gi, "stability_gate": gs,
                           "kept_by_jax": int(jkeep.sum()),
                           "flips": int((jkeep != tkeep).sum()),
                           "flip_share": float((jkeep != tkeep).mean())}
        rows.append({"frame": f"48x{w}", "frames": n_frames,
                     "proposals": int(ji.size),
                     "iou_max_abs_diff": float(np.abs(ti - ji).max()),
                     "stability_max_abs_diff": float(np.abs(ts - js).max()),
                     "gates": flips})
    return rows


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", type=int, default=24)
    args = ap.parse_args(argv)
    out = {"weights": weight_report(), "pixels": pixel_report(),
           "keep": keep_report(args.frames)}
    for row in out["weights"]:
        print(f"weights {row['in']}->{row['out']}: of {row['entries']}, "
              f"jax vs port {row['jax_vs_port']}, jax vs formula "
              f"{row['jax_vs_formula']}, port vs formula "
              f"{row['port_vs_formula']}")
    for row in out["pixels"]:
        print(f"pixels {row['frame']} -> {row['model']} (3 frames): "
              f"{row['values_differing']} of {row['values']} uint8 values "
              f"differ ({row['share_differing']:.3g}), by at most "
              f"{row['largest_gray_levels']} gray level")
    for row in out["keep"]:
        print(f"keep {row['frame']}: {row['proposals']} proposals, IoU "
              f"differs by <= {row['iou_max_abs_diff']:.3g}, stability by "
              f"<= {row['stability_max_abs_diff']:.3g}")
        for name, g in row["gates"].items():
            print(f"  {name} ({g['iou_gate']:.4f} / "
                  f"{g['stability_gate']:.4f}): {g['flips']} flips of "
                  f"{row['proposals']} ({g['flip_share']:.4%}), "
                  f"{g['kept_by_jax']} kept by JAX")
    print(json.dumps(out))


if __name__ == "__main__":
    main()
