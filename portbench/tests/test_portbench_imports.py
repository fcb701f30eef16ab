"""The measured process loads nothing of JAX or of the JAX package,
compared by whole top-level names (``tarl_tpu_torch`` begins with
``tarl_tpu`` and is the program), and refuses to run without a card or
without the program."""
import os
import shutil
import subprocess
import sys

import pytest

from portbench import harness


def test_top_level_names_are_compared_whole():
    loaded = ["jax", "jax.numpy", "jaxlib.xla_client", "flax.linen",
              "tarl_tpu", "tarl_tpu.core.step", "tarl_tpu_torch",
              "tarl_tpu_torch.core.step", "jaxtyping", "portbench.harness",
              "flaxen"]
    assert harness.forbidden_modules(loaded) == [
        "flax.linen", "jax", "jax.numpy", "jaxlib.xla_client", "tarl_tpu",
        "tarl_tpu.core.step"]


@pytest.mark.parametrize("trace", [False, True])
def test_a_run_loads_neither_jax_nor_the_jax_package(tiny_root, run_child,
                                                     trace):
    out = run_child(tiny_root, "grid128_1m.sp", trace=trace)
    assert out["result"]["correct"]
    assert "tarl_tpu_torch" in out["modules"]
    assert not set(harness.FORBIDDEN_MODULES) & set(out["modules"])


def test_run_refuses_without_a_card(tiny_root):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "grid128_1m.sp",
         "--seed", "3", "--seconds", "1", "--trace", "0"],
        cwd=tiny_root, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 2
    assert out.stdout == ""


def test_a_checkout_without_the_program_fails(tmp_path, tiny_root):
    root = tmp_path / "bare"
    shutil.copytree(tiny_root / "portbench", root / "portbench")
    shutil.copy(tiny_root / "BENCHMARK.json", root / "BENCHMARK.json")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    code = ("import sys, time, torch; sys.path.insert(0, '.'); "
            "from pathlib import Path; from portbench import harness; "
            "c = harness.find_cell(Path('.'), 'grid128_1m.sp', False); "
            "harness.run_cell(c, 1, 0.0, False, torch.device('cpu'), "
            "time.perf_counter())")
    out = subprocess.run([sys.executable, "-c", code], cwd=root, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert "tarl_tpu_torch" in out.stderr
