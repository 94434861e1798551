"""Nothing the harness loads is JAX, Flax, Optax, Orbax or the JAX package,
by whole top-level names; the harness reads no root benchmark script; and
without a card, or without the program beside it, a run prints no result."""

from __future__ import annotations

import ast
import os
import shutil
import subprocess
import sys

from benchmark.core import env

FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "sola_tpu"}


def _sources():
    for d, _, files in os.walk(env.BENCH_DIR):
        if "_cache" in d or "_tmp" in d:
            continue
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_no_source_imports_a_forbidden_module():
    for path in _sources():
        tree = ast.parse(open(path).read())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            for n in names:
                assert n.split(".", 1)[0] not in FORBIDDEN, (path, n)
        if os.sep + "tests" + os.sep in path:
            continue
        text = open(path).read()
        for script in ("bench.py", "bench_trackgen.py"):
            assert f"'{script}'" not in text and f'"{script}"' not in text


def test_loaded_modules_hold_no_forbidden_top_level_name():
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "import benchmark.run as run\n"
        "import benchmark.drivers.trackgen_grid, benchmark.drivers.train_select\n"
        "import benchmark.reference.trackgen, benchmark.reference.train_select\n"
        "import benchmark.counts.sam2_hiera_l, benchmark.counts.sola_selection_mevis\n"
        "import sola_torch.trackgen.tokens_grid, sola_torch.train.loop\n"
        "import sola_torch.trackgen.sam2.video, sola_torch.data.dataset\n"
        "from benchmark.core import manifest\n"
        "[manifest.load_reader(m['name']) for m in manifest.manifest()['per_layer']]\n"
        "print(','.join(run.forbidden_modules()))\n" % env.ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == ""


def test_forbidden_names_compare_whole_top_level_names():
    import benchmark.run as run
    sys.modules["jax_like_but_not"] = sys
    sys.modules["sola_tpu_torch"] = sys
    try:
        assert run.forbidden_modules() == []
    finally:
        del sys.modules["jax_like_but_not"], sys.modules["sola_tpu_torch"]


def test_no_result_without_a_card_or_without_the_program(tmp_path):
    """Here there is no card: exit 2 and no result line. In a directory
    with only BENCHMARK.json and benchmark/ the run fails too."""
    args = ["--workload", "trackgen_l.grid_dense", "--seed", "1",
            "--seconds", "1", "--trace", "0"]
    out = subprocess.run([sys.executable, "benchmark/run.py", *args],
                         cwd=env.ROOT, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
    bare = tmp_path / "bare"
    shutil.copytree(env.BENCH_DIR, bare / "benchmark",
                    ignore=shutil.ignore_patterns("_cache", "_tmp",
                                                  "__pycache__"))
    shutil.copy(os.path.join(env.ROOT, "BENCHMARK.json"), bare)
    out = subprocess.run([sys.executable, "benchmark/run.py", *args],
                         cwd=bare, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
