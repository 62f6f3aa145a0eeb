"""
The readings a cell's limit is set from, on the card at the cell's own
size: for each seed, a short window of the cell's traffic through the
program and the errors of its sampled steps from the f64 reference (the
lower reading is their largest over the seeds); and for the control seeds,
the reference computed in TF32 in the program's place, on the same steps
(the upper reading is its smallest).

    python3 port_bench/calibrate.py --workload <cell> --seeds 1,2,3 \
        --control-seeds 1,2,3 --seconds 2 [--out FILE]

Each seed prints one JSON line; ``--out`` also writes them all to FILE.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def readings(spec, seed, seconds, control, device):
    from port_bench import harness

    entry, runner, events = harness.prepare(spec, seed, device)
    runner.run_once(entry.initial(), 0)
    n, wall, _ = harness.dispatch_ahead(runner, events, seconds=seconds)
    samples = harness.release(entry, runner, device)
    row = {"seed": seed, "steps": n, "window_s": wall,
           "program": harness.errors(entry, samples)}
    if control:
        t = time.perf_counter()
        row["control_tf32"] = harness.errors(entry, samples, control="tf32")
        row["control_s"] = time.perf_counter() - t
    return row


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True)
    parser.add_argument("--control-seeds", default="")
    parser.add_argument("--seconds", type=float, default=2.0)
    parser.add_argument("--out")
    args = parser.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from port_bench import harness

    if not torch.cuda.is_available():
        print("calibrate.py needs a CUDA device", file=sys.stderr)
        return 2
    spec = harness.Spec(ROOT, args.workload)
    control = {int(s) for s in args.control_seeds.split(",") if s}
    rows = []
    for seed in (int(s) for s in args.seeds.split(",")):
        row = readings(spec, seed, args.seconds, seed in control,
                       torch.device("cuda:0"))
        row["device"] = torch.cuda.get_device_name(0)
        rows.append(row)
        print(json.dumps(row), flush=True)
        torch.cuda.empty_cache()
    program = [max(r["program"]) for r in rows]
    ctl = [max(r["control_tf32"]) for r in rows if "control_tf32" in r]
    summary = {"workload": args.workload, "lower": max(program),
               "upper": min(ctl) if ctl else None, "seeds": len(rows)}
    print(json.dumps(summary), flush=True)
    if args.out:
        Path(args.out).write_text(
            "\n".join(json.dumps(r) for r in rows + [summary]) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
