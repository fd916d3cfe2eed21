"""The benchmark's files, found by name.

`BENCHMARK.json` names each cell's configuration and traffic mix; this
module reads them and the files beside them. Nothing here imports torch or
the port, so the CPU tests and the import check can load it alone.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path
from types import ModuleType

ROOT = Path(__file__).resolve().parent.parent
#: Top-level module names that no process of the benchmark may hold.
FORBIDDEN_MODULES = frozenset({"jax", "jaxlib", "flax", "blp_tpu"})


def load_benchmark(root: Path = ROOT) -> dict:
    """`BENCHMARK.json` at the root of the checkout."""
    path = Path(root) / "BENCHMARK.json"
    if not path.is_file():
        raise FileNotFoundError(f"{path} is missing")
    return json.loads(path.read_text())


def workload(spec: dict, name: str) -> dict:
    """The cell `name` of `spec`."""
    for cell in spec["workloads"]:
        if cell["name"] == name:
            return cell
    raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                   f"(have {[c['name'] for c in spec['workloads']]})")


def load_config(spec: dict, name: str, root: Path = ROOT) -> dict:
    """The configuration `name`: its file, as `configs` in `spec` names it."""
    for entry in spec["configs"]:
        if entry["name"] == name:
            return json.loads((Path(root) / entry["file"]).read_text())
    raise KeyError(f"no configuration {name!r} in BENCHMARK.json")


def load_traffic(name: str, root: Path = ROOT) -> dict:
    """The traffic mix `name`: `benchmark/traffic/<name>.json`."""
    return json.loads((Path(root) / "benchmark" / "traffic" / f"{name}.json").read_text())


def load_limits(name: str, root: Path = ROOT) -> dict:
    """The limits of the numbers that decide `correct` in workload `name`:
    `benchmark/limits/<name>.json`, {number: limit}."""
    data = json.loads((Path(root) / "benchmark" / "limits" / f"{name}.json").read_text())
    return {k: float(v["limit"]) for k, v in data["limits"].items()}


def metrics_of(spec: dict, cell_name: str, kind: str) -> list[dict]:
    """The metrics of `kind` ("end_to_end" or "per_layer") that cell
    `cell_name` reports: those whose `workloads` list it, or that have no
    such list."""
    return [m for m in spec[kind]
            if "workloads" not in m or cell_name in m["workloads"]]


def _module_from_file(path: Path, name: str) -> ModuleType:
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise ImportError(f"cannot load {path}")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def metric_reader(name: str, root: Path = ROOT) -> ModuleType:
    """The reader of per-layer metric `name`: `benchmark/metrics/<name>.py`,
    whose `read(ctx)` returns the value or None where it finds nothing to
    read."""
    path = Path(root) / "benchmark" / "metrics" / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no reader {path} for per-layer metric {name!r}")
    return _module_from_file(path, f"benchmark_metric_{name.replace('.', '_')}")


def driver(kind: str) -> ModuleType:
    """The driver of a traffic mix's `kind`: `drivers/<kind>.py`."""
    return importlib.import_module(f"benchmark.drivers.{kind}")


def family(name: str) -> ModuleType:
    """A model family's counts and plain reference: `models/<name>.py`."""
    return importlib.import_module(f"benchmark.models.{name}")


def kernel_layers(root: Path = ROOT) -> list[tuple[str, str]]:
    """(regular expression, layer) pairs, first match wins, from
    `benchmark/kernel_layers.json`."""
    data = json.loads((Path(root) / "benchmark" / "kernel_layers.json").read_text())
    return [(e["pattern"], e["layer"]) for e in data["layers"]]


def forbidden_loaded(modules) -> list[str]:
    """The forbidden top-level names among `modules` (module names, such as
    the keys of sys.modules), compared whole: `blp_tpu_torch` is not
    `blp_tpu`."""
    return sorted({m.split(".")[0] for m in modules} & FORBIDDEN_MODULES)
