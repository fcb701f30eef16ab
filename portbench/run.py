"""Run one cell of the benchmark of ``tarl_tpu_torch`` once, on one NVIDIA
card:

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout.  The cells, their configurations, traffic and
metrics are named in ``BENCHMARK.json`` and found in ``portbench/``.
``--trace 0`` reports the cell's end-to-end metrics, ``--trace 1`` its
per-layer ones (with ``device.busy_s``, ``device.window_s`` and a
``breakdown``).  The last line of standard output is the result, a JSON
object; the numbers that decide ``correct`` close standard error and the
result's line.  Without a CUDA device, or with fewer than the cell asks
for, the run prints no result and exits with 2; if the process holds a
module of JAX or of the JAX package once the window has closed, with 3.
Kernel libraries are built into ``build/`` inside the checkout on the
first run and found there afterwards.
"""
import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def card_power_limit() -> str:
    """The card's name and power limit as ``nvidia-smi`` reads them, or
    ``not read``."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return "not read"
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 \
        and out.stdout.strip() else "not read"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    sys.path.insert(0, str(ROOT))
    import torch

    from portbench import harness

    spec = harness.load_json(ROOT / "BENCHMARK.json")
    chips = {w["name"]: w["chips"] for w in spec["workloads"]}
    if args.workload not in chips:
        print(f"no workload {args.workload!r} in BENCHMARK.json",
              file=sys.stderr)
        return 2
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < chips[args.workload]:
        print("no CUDA device, or fewer than the cell asks for: "
              "this benchmark measures the card only", file=sys.stderr)
        return 2
    cell = harness.find_cell(ROOT, args.workload, bool(args.trace))
    device = torch.device("cuda", 0)
    result = harness.run_cell(cell, args.seed, args.seconds,
                              bool(args.trace), device, STARTED)
    found = harness.forbidden_modules(sys.modules)
    if found:
        print("modules of JAX or the JAX package loaded: " + ", ".join(found),
              file=sys.stderr)
        return 3
    checks = result.pop("checks")
    result["card"] = card_power_limit()
    result["checks"] = checks
    for name, c in checks.items():
        print(f"check {name} {c['value']} limit {c['limit']}",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
