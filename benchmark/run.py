"""Run one cell of `BENCHMARK.json` once.

    python3 -m benchmark.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

Loads the cell's configuration and traffic mix by name, makes the inputs
and weights from the seed, builds and warms up the program (set-up), drives
the timed path for `--seconds` (the window), then checks what the window
produced against the plain reference. With `--trace 1` the window runs
under the profiler and the cell's per-layer metrics are reported; with
`--trace 0`, its end-to-end metrics. The last line of standard output is
one JSON object (`correct`, `attempted`, `failed`, `metrics`, `device`,
with `--trace 1` `breakdown`, and `checks` last); the last lines of
standard error are the numbers compared, each beside its limit.

Exits non-zero, printing no result, without a CUDA device (or with fewer
than the cell asks for), and where jax, jaxlib, flax or the JAX package
(`blp_tpu`) is loaded once the window has closed.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

from benchmark import spec  # noqa: E402

#: Compile caches at fixed paths inside the checkout.
CACHES = {"TORCH_EXTENSIONS_DIR": "build/torch_extensions",
          "TRITON_CACHE_DIR": "build/triton", "CUDA_CACHE_PATH": "build/cuda_cache"}


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


@dataclasses.dataclass
class Context:
    """What a per-layer reader reads (`metrics/<name>.py` `read(ctx)`)."""
    window: object
    trace: object
    peak_bytes: int
    lost: bool
    layers: list


def lost_events(trace, before: dict, after: dict) -> list[str]:
    """The launch counters whose kernels the trace holds fewer or more of
    than the program launched in the window."""
    out = []
    for pattern, n0 in before.items():
        launched = after[pattern] - n0
        seen = trace.time_by(pattern)[1]
        if launched and seen != launched:
            out.append(f"{pattern}: {launched} launched, {seen} traced")
    return out


def execute(workload: str, seed: int, seconds: float, trace: bool, device,
            *, fault: str | None = None, root=spec.ROOT, log=sys.stderr) -> dict:
    """One run of `workload` on `device`; returns the result's dict. The
    CPU tests call it with a CPU device and a planted `fault`."""
    import torch

    from benchmark import harness
    from benchmark import trace as tracing

    bench = spec.load_benchmark(root)
    cell = spec.workload(bench, workload)
    config = spec.load_config(bench, cell["config"], root)
    traffic = spec.load_traffic(cell["traffic"], root)
    limits = spec.load_limits(workload, root)
    run = harness.Run(workload, seed, torch.device(device), config, traffic, fault)
    drv = spec.driver(traffic["kind"])
    cuda = run.device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(run.device)
        info = harness.card(run.device)
        print(f"card: {info['name']}, power limit {info['power_limit']}", file=log)

    state = drv.setup(run)
    harness.sync(run.device)
    setup_s = time.perf_counter() - T_START
    print(f"setup_s {setup_s:.3f}", file=log)

    traced, lost = None, False
    if trace:
        before = harness.port_counters()
        with tracing.profiler() as prof:
            with tracing.span(tracing.WINDOW):
                win = drv.window(run, state, seconds)
        after = harness.port_counters()
        traced = tracing.Trace.from_profile(prof)
        del prof
        missing = lost_events(traced, before, after)
        if missing:
            lost = True
            print("profiler lost events; device times left out: "
                  + "; ".join(missing), file=log)
    else:
        win = drv.window(run, state, seconds)
    peak = int(torch.cuda.max_memory_allocated(run.device)) if cuda else 0
    print(f"window: {win.units} units in {win.seconds:.3f} s, {win.steps} calls",
          file=log)

    drv.release(state)
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    # The numbers compared are those the cell's limits file names; a
    # driver's other readings (no limit holds for them) are left out.
    found = drv.check(run, state)
    print(f"check took {time.perf_counter() - t0:.1f} s", file=log)
    checks = {k: found.get(k, float("nan")) for k in limits}
    correct = all(checks[k] <= limits[k] for k in limits)

    metrics = {}
    if trace:
        ctx = Context(win, traced, peak, lost, spec.kernel_layers(root))
        for m in spec.metrics_of(bench, workload, "per_layer"):
            value = spec.metric_reader(m["name"], root).read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = {traffic["rate_metric"]: win.rate, "setup_s": setup_s}
        for m in spec.metrics_of(bench, workload, "end_to_end"):
            if m["name"] in values:
                metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}

    result = {"correct": bool(correct), "attempted": int(win.attempted),
              "failed": int(win.failed), "metrics": metrics,
              "device": {"platform": "gpu" if cuda else run.device.type,
                         "kind": torch.cuda.get_device_name(run.device) if cuda else "cpu",
                         "count": int(cell["chips"]), "memory_peak_bytes": peak}}
    if traced is not None:
        result["device"]["busy_s"] = traced.busy_s
        result["device"]["window_s"] = traced.window_s
        result["breakdown"] = traced.breakdown()
    result["checks"] = {k: {"value": v, "limit": limits[k]} for k, v in checks.items()}
    return result


def main(argv=None) -> int:
    args = parse(argv)
    for var, path in CACHES.items():
        os.environ[var] = str(spec.ROOT / path)
    import torch

    bench = spec.load_benchmark()
    chips = int(spec.workload(bench, args.workload)["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"benchmark: needs {chips} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = execute(args.workload, args.seed, args.seconds, bool(args.trace),
                     "cuda")
    found = spec.forbidden_loaded(sys.modules)
    if found:
        print(f"benchmark: {', '.join(found)} loaded in the measuring process",
              file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
