"""The control of the comparison that decides ``correct``: the reference
put in the program's place and computed in the nearest precision below the
configuration's float32, its time stamps stored in bfloat16 after every
tick, judged by the comparison the benchmark's runs use.

    python3 portbench/control.py --workload <cell> --seeds 11,12,13 \\
        [--device cuda]

For each seed it prints one JSON line: the control's ``init_mismatch``
(its initial state against the reference's) and ``start_mismatch`` (its
first ``L`` ticks of the first replay against the reference's), each
beside the limit.  A control that comes out correct would show the
comparison cannot see a lower precision.  The benchmark's runs do not run
it.
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def control_readings(root: Path, workload: str, seed: int, device) -> dict:
    """The control's two readings for ``seed``."""
    import torch

    from portbench import check, harness

    cell = harness.find_cell(root, workload, False)
    drv = harness.driver(cell)
    kind = harness.scenario(cell.config["scenario"])
    net_arrays = kind.network(cell.config)
    pop = kind.population(cell.config, net_arrays, seed)
    sp = harness.spans(cell, seed)
    key0 = harness.seed_words(seed, 0)
    ref = drv.Reference(cell, net_arrays, pop, device)
    low = drv.Reference(cell, net_arrays, pop, device, lower=torch.bfloat16)
    ref0, low0 = ref.initial(), low.initial()
    init = check.mismatches(low0, ref0)
    ref_state, ref_logs = ref.run(ref0._replace(key=key0), sp.span)
    low_state, low_logs = low.run(low0._replace(key=key0), sp.span)
    start = (check.mismatches(low_state, ref_state)
             + check.mismatches(low_logs, ref_logs))
    return {"workload": workload, "seed": seed,
            "init_mismatch": {"value": init, "limit": 0},
            "start_mismatch": {"value": start, "limit": 0},
            "correct": init == 0 and start == 0}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    device = torch.device(args.device)
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        out = control_readings(ROOT, args.workload, seed, device)
        out["seconds"] = time.perf_counter() - t0
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
