"""Readings for the limits of `correct`, on the chip (the benchmark's own
runs never call this).

    python3 -m benchmark.calibrate --workload <name> --what program --seeds 1,2,3
    python3 -m benchmark.calibrate --workload <name> --what control --seeds 4,5,6
    python3 -m benchmark.calibrate --workload <name> --what half_batch --seeds 7,8,9

program: the numbers a run compares, from the program at the cell's own
sizes (its set-up and a window of `--seconds`, long enough to keep as many
answers as a run keeps). control: the same numbers with the plain reference
in the program's place, in the precision one step below the one the
configuration states (`CONTROL`). A fault's name (training cells):
the program with that fault planted under its timed path. One process
runs every seed in turn; each seed prints one JSON line.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time

import torch

from benchmark import harness, spec

#: The control's precision, by the precision the configuration states.
CONTROL = {"bf16": "fp8", "fp32": "tf32"}


def control_mode(config: dict, kind: str) -> str:
    if kind == "rank":
        return "bf16"        # the table and offsets are float32
    key = "training" if kind == "train" else "inference"
    return CONTROL[config[key]["precision"]]


def readings(workload: str, seed: int, what: str, seconds: float,
             device="cuda", root=spec.ROOT) -> dict:
    """The compared numbers of one seed: the program's, the control's, or
    the program's with the fault `what` planted."""
    bench = spec.load_benchmark(root)
    cell = spec.workload(bench, workload)
    config = spec.load_config(bench, cell["config"], root)
    traffic = spec.load_traffic(cell["traffic"], root)
    kind = traffic["kind"]
    fault = what if what not in ("program", "control") else None
    run = harness.Run(workload, seed, torch.device(device), config, traffic, fault)
    drv = spec.driver(kind)
    st = drv.setup(run)
    drv.window(run, st, seconds)
    drv.release(st)
    gc.collect()
    if run.device.type == "cuda":
        torch.cuda.empty_cache()
    if kind == "train":
        ref = drv.reference_readings(run, st)
        got = (drv.reference_readings(run, st, control_mode(config, kind))
               if what == "control" else drv.program_readings(st))
        return {**drv.compare(got, ref), "worst": drv.worst_leaves(got, ref),
                "losses": got["losses"], "reference_losses": ref["losses"]}
    if what != "control":
        return drv.check(run, st)
    mode = control_mode(config, kind)
    if kind == "encode":
        pick = drv.sample(run, st)
        ids = st.kept_ids[pick]
        return drv.compare(drv.reference_rows(run, st, ids, mode),
                           drv.reference_rows(run, st, ids))
    picked = drv.sample(run, st)
    bs, t = traffic["eval_batch_size"], traffic["graph"]["test_triples"]
    real = [min(bs, t - b * bs) for _, b, _ in picked]
    return drv.compare([drv.reference_counts(run, st, b, mode) for _, b, _ in picked],
                       [drv.reference_counts(run, st, b) for _, b, _ in picked], real)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--what", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=0.0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("calibrate: needs a CUDA device", file=sys.stderr)
        return 2
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        out = readings(args.workload, seed, args.what, args.seconds)
        print(json.dumps({"workload": args.workload, "what": args.what, "seed": seed,
                          "readings": out, "s": round(time.perf_counter() - t0, 1)}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
