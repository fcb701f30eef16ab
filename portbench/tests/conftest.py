"""Fixtures of the benchmark's own tests: a tiny copy of the benchmark (its
files and ``BENCHMARK.json``, every configuration shrunk to a few dozen
intersections and a few hundred commuters, every replay to 200 ticks) that
runs on the CPU, in this process or in a fresh one.

Run from the root of the checkout: ``python -m pytest portbench/tests``.
The tests that need a card carry the ``cuda`` marker and decide inside
the test whether a card is present.
"""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

TINY_GRID = dict(rows=6, cols=7, num_agents=600, zones=5, peak_spread=200)
TINY_CITY = dict(num_intersections=300, extent=[3250.0, 2625.0],
                 num_agents=800, zones=8, peak_spread=200)


def make_tiny(dst: Path) -> Path:
    """A tiny copy of the benchmark under ``dst`` (the program linked in):
    the same files, the configurations and traffic shrunk in place."""
    shutil.copytree(REPO / "portbench", dst / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(REPO / "BENCHMARK.json", dst / "BENCHMARK.json")
    os.symlink(REPO / "tarl_tpu_torch", dst / "tarl_tpu_torch")
    spec = json.loads((dst / "BENCHMARK.json").read_text())
    for c in spec["configs"]:
        path = dst / c["file"]
        cfg = json.loads(path.read_text())
        cfg.update(TINY_GRID if cfg["scenario"] == "grid" else TINY_CITY)
        cfg["simulated_s"] = 200
        path.write_text(json.dumps(cfg))
    for w in spec["workloads"]:
        path = dst / "portbench" / "traffic" / f"{w['traffic']}.json"
        t = json.loads(path.read_text())
        if "insert_backlog" in t["sim"]:
            t["sim"]["insert_backlog"] = 16
        path.write_text(json.dumps(t))
    return dst


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory) -> Path:
    return make_tiny(tmp_path_factory.mktemp("tiny"))


def run_tiny(root: Path, workload: str, seed: int = 7, trace: bool = False,
             seconds: float = 0.0) -> dict:
    """One run of a cell of the tiny copy on the CPU, in this process."""
    import time

    import torch

    from portbench import harness

    cell = harness.find_cell(root, workload, trace)
    return harness.run_cell(cell, seed, seconds, trace, torch.device("cpu"),
                            time.perf_counter())


# Run a cell of the copy at sys.argv[1] on the CPU in a fresh process, and
# print the result and the top-level names of every loaded module.
_CHILD = """
import json, sys, time
sys.path.insert(0, sys.argv[1])
import torch
from pathlib import Path
from portbench import harness
cell = harness.find_cell(Path(sys.argv[1]), sys.argv[2], sys.argv[3] == "1")
res = harness.run_cell(cell, 5, 0.0, sys.argv[3] == "1", torch.device("cpu"),
                       time.perf_counter())
print(json.dumps({"result": res, "harness": harness.__file__,
                  "modules": sorted({m.split(".")[0] for m in sys.modules})}))
"""


def run_child(root: Path, workload: str, trace: bool = False) -> dict:
    """:func:`run_tiny` in a fresh interpreter whose first path entry is
    ``root``; its result, the harness file it ran and its modules' top-level
    names."""
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run(
        [sys.executable, "-c", _CHILD, str(root), workload,
         "1" if trace else "0"], capture_output=True, text=True, env=env,
        cwd=root, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.fixture(name="run_tiny")
def _run_tiny():
    return run_tiny


@pytest.fixture(name="run_child")
def _run_child():
    return run_child


@pytest.fixture(name="make_tiny")
def _make_tiny():
    return make_tiny
