"""The benchmark of the PyTorch and CUDA port (`blp_tpu_torch`).

One command runs one cell of `BENCHMARK.json` once:

    python3 -m benchmark.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

Everything that belongs to one configuration, traffic mix or per-layer
metric sits in a file of its own, found by name: `configs/<config>.json`,
`traffic/<mix>.json` (read by the driver its `kind` names, `drivers/`),
`metrics/<metric>.py` and `limits/<workload>.json`. `models/` holds each
model family's operation counts and plain reference, which import nothing
of the port.
"""
