"""The port's launchers, ``scripts/torch/*.sh``: one for each of the JAX
package's ``scripts/*.sh`` that drives a CLI, with the same name,
arguments and canonical flags. Each launcher runs here with a stand-in
``python`` on the PATH that records its command line, beside its JAX twin
given the same arguments: the two command lines must be equal but for the
package, the module it names must exist in ``sola_torch``, and that
module's own parser must accept the flags (it raises on an unknown one)."""

import argparse
import importlib
import importlib.util
import os
import subprocess

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = os.path.join(ROOT, "scripts")
# the JAX package's launchers with no port: TPU probes and XLA's cache
NOT_PORTED = {"r5_onchip_probes.sh", "warm_cache.sh"}
# positional arguments of each launcher, then flags passed through
ARGS = {"train": ["mevis/default"], "eval": ["mevis/default", "3"],
        "inference": ["mevis/default", "3"]}
PID_ARGS = ["1", "4"]
EXTRA = ["--device", "cpu"]
LAUNCHERS = sorted(n[:-3] for n in os.listdir(os.path.join(SCRIPTS, "torch"))
                   if n.endswith(".sh"))


class Parsed(Exception):
    """Raised by the stand-in parse_args once the module's parser has
    accepted the command line."""


def command_line(script: str, args: list, tmp_path) -> list:
    """The arguments that ``script`` hands to ``python``."""
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir(exist_ok=True)
    fake = bin_dir / "python"
    fake.write_text('#!/bin/sh\nprintf \'%s\\0\' "$@" > "$ARGV_OUT"\n')
    fake.chmod(0o755)
    out = tmp_path / "argv"
    env = dict(os.environ, PATH=f"{bin_dir}{os.pathsep}{os.environ['PATH']}",
               ARGV_OUT=str(out))
    subprocess.run(["bash", script, *args], env=env, check=True,
                   timeout=30)
    return out.read_bytes().decode().split("\0")[:-1]


def test_every_cli_launcher_has_a_port():
    jax_side = {n[:-3] for n in os.listdir(SCRIPTS)
                if n.endswith(".sh") and n not in NOT_PORTED}
    assert set(LAUNCHERS) == jax_side
    assert len(LAUNCHERS) == 12


def parse_with_module(module, argv: list, monkeypatch):
    """The module's own parser over ``argv``: the CLIs' ``get_configs``,
    the trackgen stages' ``main`` stopped right after its parse_args."""
    if module.__name__.startswith("sola_torch.cli."):
        return module.get_configs(argv)
    real = argparse.ArgumentParser.parse_args

    def parse_and_stop(self, args=None, namespace=None):
        raise Parsed(real(self, args, namespace))

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args",
                        parse_and_stop)
    with pytest.raises(Parsed) as parsed:
        module.main(argv)
    return parsed.value.args[0]


@pytest.mark.parametrize("name", LAUNCHERS)
def test_launcher_matches_its_jax_twin(name, tmp_path, monkeypatch):
    with open(os.path.join(SCRIPTS, f"{name}.sh")) as f:
        takes_pid = "PID=${1" in f.read()
    args = ARGS.get(name, PID_ARGS if takes_pid else []) + EXTRA
    port = command_line(os.path.join(SCRIPTS, "torch", f"{name}.sh"), args,
                        tmp_path)
    twin = command_line(os.path.join(SCRIPTS, f"{name}.sh"), args, tmp_path)
    assert port[0] == "-m" and port[1].startswith("sola_torch.")
    assert port == [twin[0], twin[1].replace("sola_tpu.", "sola_torch.",
                                             1), *twin[2:]]
    assert port[-2:] == EXTRA  # extra flags pass through
    assert importlib.util.find_spec(port[1]) is not None, port[1]
    parsed = parse_with_module(importlib.import_module(port[1]), port[2:],
                               monkeypatch)
    if name in ("train", "eval", "inference"):
        configs, device = parsed[0], parsed[-1]
        assert device == "cpu"
        assert configs["exp_name"] == "default"
        if name != "train":
            assert configs["eval_weight_epoch"] == 3
    else:
        assert parsed.device == "cpu"
        if takes_pid:
            assert (parsed.pid, parsed.n_pids) == (1, 4)
