"""The plain references agree with the port at tiny sizes on the CPU, and
a run with the timed path broken underneath comes out not correct."""

from __future__ import annotations

import pytest

from benchmark.core import device as device_lib
from benchmark.tests import tiny


def _checks(readings, limits):
    return [device_lib.check(k, readings[k], float(v))
            for k, v in limits.items()]


def test_trackgen_reference_agrees_with_the_port(cpu_harness):
    from benchmark.drivers import trackgen_grid as tg
    rec, cell, got, ref = tiny.trackgen(seed=2 ** 31 + 11)
    r = tg.compare(got, ref)
    assert len(ref["tracks"]) == 16 and r["status_mismatch"] == 0
    assert r["token_gap"] < 1e-4 and r["mask_gap"] < 1e-3
    assert r["feature_gap"] < 1e-5
    cell.cleanup()


def test_train_reference_agrees_with_the_port(cpu_harness):
    from benchmark.drivers import train_select as ts
    rec, cell, got, ref = tiny.train(seed=2 ** 31 + 12)
    r = ts.compare(got, ref)
    assert r["loss_gap"] < 1e-5 and r["grad_gap"] < 1e-5
    assert r["update_gap"] < 1e-3
    cell.cleanup()


def test_an_altered_token_fails_the_trackgen_checks(cpu_harness,
                                                    monkeypatch):
    """A token altered where the predictor produces it."""
    from benchmark.drivers import trackgen_grid as tg
    from sola_torch.trackgen.sam2 import video
    orig = video.SAM2VideoPredictor.get_output_tokens

    def altered(self, state):
        out = orig(self, state)
        f = sorted(out)[len(out) // 2]
        out[f] = out[f] * 1.5
        return out

    monkeypatch.setattr(video.SAM2VideoPredictor, "get_output_tokens",
                        altered)
    rec, cell, got, ref = tiny.trackgen(seed=2 ** 31 + 13)
    checks = _checks(tg.compare(got, ref),
                     rec.config["limits"]["trackgen_grid"])
    assert not all(c["ok"] for c in checks)
    cell.cleanup()


def test_an_encoder_output_altered_by_a_thousandth_fails(cpu_harness,
                                                         monkeypatch):
    """The image encoder's output altered where it is produced, by less
    than the tokens' limit sees: ``feature_gap`` fails alone."""
    from benchmark.drivers import trackgen_grid as tg
    from sola_torch.trackgen.sam2 import image_encoder
    orig = image_encoder.ImageEncoder.forward

    def altered(self, images):
        out = orig(self, images)
        out["backbone_fpn"] = [x * 1.001 for x in out["backbone_fpn"]]
        return out

    monkeypatch.setattr(image_encoder.ImageEncoder, "forward", altered)
    rec, cell, got, ref = tiny.trackgen(seed=2 ** 31 + 17)
    r = tg.compare(got, ref)
    limits = rec.config["limits"]["trackgen_grid"]
    assert r["token_gap"] <= limits["token_gap"]
    assert r["feature_gap"] > limits["feature_gap"]
    cell.cleanup()


def test_a_step_that_changes_nothing_fails_the_train_checks(cpu_harness,
                                                            monkeypatch):
    """A step that returns its state unchanged (the optimizer never
    steps)."""
    from benchmark.drivers import train_select as ts
    from sola_torch.train import state as state_lib
    monkeypatch.setattr(state_lib.Optimizer, "step",
                        lambda self: self.clip())
    rec, cell, got, ref = tiny.train(seed=2 ** 31 + 14)
    r = ts.compare(got, ref)
    assert r["update_gap"] == pytest.approx(1.0)
    checks = _checks(r, rec.config["limits"]["train_select"])
    assert not all(c["ok"] for c in checks)
    cell.cleanup()


def test_an_altered_loss_fails_the_train_checks(cpu_harness, monkeypatch):
    """An answer altered where it is produced: the step's loss."""
    from benchmark.drivers import train_select as ts
    from sola_torch.train import loss as loss_lib
    orig = loss_lib.total_loss

    def altered(*a, **k):
        loss, parts = orig(*a, **k)
        return loss * 1.01, {**parts, "total": loss * 1.01}

    monkeypatch.setattr(loss_lib, "total_loss", altered)
    rec, cell, got, ref = tiny.train(seed=2 ** 31 + 15)
    checks = _checks(ts.compare(got, ref),
                     rec.config["limits"]["train_select"])
    assert not all(c["ok"] for c in checks)
    cell.cleanup()


def test_gt_packed_reference_agrees_with_the_port(cpu_harness):
    from benchmark.drivers import trackgen_gt_packed as gp
    rec, cell, got, ref = tiny.gt_packed(seed=2 ** 31 + 16)
    r = gp.compare(got, ref)
    assert ref["tracks"] and r["status_mismatch"] == 0
    assert r["token_gap"] < 1e-4 and r["mask_gap"] < 1e-3
    assert r["feature_gap"] < 1e-5
    cell.cleanup()
