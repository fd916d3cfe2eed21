"""What the drivers share: the run's context, the window's result, the
port's launch counters, and the device helpers.

A driver (`drivers/<kind>.py`) has four functions, called in this order:
`setup(run)` returns its state, the program built and warmed up;
`window(run, state, seconds)` drives the timed path and returns a
`Window`; `release(state)` drops the program's state once the peak memory
has been read; `check(run, state)` returns the numbers compared with the
plain reference, {name: value}, each to be at most its limit.
"""

from __future__ import annotations

import dataclasses
import importlib
import subprocess

import torch

from benchmark import spec


@dataclasses.dataclass
class Run:
    workload: str
    seed: int
    device: torch.device
    config: dict
    traffic: dict
    #: A fault planted under the timed path (tests and calibration only).
    fault: str | None = None

    @property
    def family(self):
        return spec.family(self.config["family"])

    @property
    def port(self):
        return importlib.import_module(f"benchmark.ports.{self.config['family']}")


@dataclasses.dataclass
class Window:
    """The timed window: `units` of work (triples or entities) in
    `seconds`, `steps` calls of the timed entry, `attempted` and `failed`
    units, and the work's operations counted from shapes (`flops`: model
    FLOPs; `rank_ops`: the rank distances' fp32 adds)."""

    units: int
    seconds: float
    steps: int
    attempted: int
    failed: int = 0
    flops: float | None = None
    rank_ops: float | None = None

    @property
    def rate(self) -> float:
        return self.units / self.seconds


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def flatten(tree, prefix: str = "") -> dict:
    """The port's parameter (or Adam moment) tree as {path: tensor}; a
    tuple of layer dicts gives `<path>/<leaf>@<i>`."""
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(flatten(v, f"{prefix}/{k}" if prefix else k))
    elif isinstance(tree, (tuple, list)):
        for i, layer in enumerate(tree):
            for k, v in layer.items():
                out[f"{prefix}/{k}@{i}"] = v
    else:
        out[prefix] = tree
    return out


#: The port's launch counters (plain module counters in `blp_tpu_torch.ops`)
#: and the kernel names each counts, as a pattern over the profiler's names.
COUNTERS = {
    "transe_rank": ("transe_rank", "launches"),
    "bias_act_fwd": ("fused_layer", "bias_act_launches"),
    "bias_act_bwd": ("fused_layer", "bias_act_backward_launches"),
    "add_ln_fwd": ("fused_layer", "add_layer_norm_launches"),
    "add_ln_bwd": ("fused_layer", "add_layer_norm_backward_launches"),
    "attn_softmax\\w*_fwd": ("attn_softmax", "launches"),
    "attn_softmax\\w*_bwd": ("attn_softmax", "backward_launches"),
}


def port_counters() -> dict[str, int]:
    out = {}
    for pattern, (module, name) in COUNTERS.items():
        mod = importlib.import_module(f"blp_tpu_torch.ops.{module}")
        out[pattern] = int(getattr(mod, name))
    return out


def card(device) -> dict:
    """The card's name and power limit (nvidia-smi), for the run's log."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return {"name": "cpu", "power_limit": "n/a"}
    index = torch.cuda.current_device() if dev.index is None else dev.index
    try:
        limit = subprocess.run(
            ["nvidia-smi", "-i", str(index), "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        limit = f"unread ({type(e).__name__})"
    return {"name": torch.cuda.get_device_name(dev), "power_limit": limit}
