"""Which collectives gloo takes for CUDA tensors, with two ranks on one card.

    python -m blp_tpu_torch.tools.gloo_probe [--out build/gloo_probe.json]

Each collective runs in a world of its own (two spawned ranks on cuda:0),
so one that aborts its process does not take the others with it. Prints and
writes {collective: "ok" | "WRONG" | the error}, and the host time of one
all_reduce of CUDA tensors at 256 B, 256 KiB and 16 MiB. parallel/comm.py
routes around what this finds missing.
"""

from __future__ import annotations

import argparse
import datetime
import json
import os
import sys
import tempfile
import time

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def _cases(rank: int, world: int, dev):
    def all_reduce():
        t = torch.full((1000,), float(rank + 1), device=dev)
        dist.all_reduce(t)
        return bool((t == 3.0).all())

    def int32_all_reduce():
        t = torch.full((64,), rank + 1, dtype=torch.int32, device=dev)
        dist.all_reduce(t)
        return bool((t == 3).all())

    def all_gather():
        t = torch.full((10,), float(rank), device=dev)
        outs = [torch.empty_like(t) for _ in range(world)]
        dist.all_gather(outs, t)
        return all(bool((o == i).all()) for i, o in enumerate(outs))

    def all_gather_into_tensor():
        t = torch.full((10,), float(rank), device=dev)
        o = torch.empty(20, device=dev)
        dist.all_gather_into_tensor(o, t)
        return bool((o[:10] == 0).all() and (o[10:] == 1).all())

    def broadcast():
        t = torch.full((10,), float(rank + 5), device=dev)
        dist.broadcast(t, src=1)
        return bool((t == 6.0).all())

    def reduce_scatter_tensor():
        t = torch.ones(20, device=dev)
        o = torch.empty(10, device=dev)
        dist.reduce_scatter_tensor(o, t)
        return bool((o == 2).all())

    def send_recv():
        t = torch.full((10,), 7.0 if rank == 0 else 0.0, device=dev)
        if rank == 0:
            dist.send(t, dst=1)
        else:
            dist.recv(t, src=0)
        return bool((t == 7.0).all())

    def isend_irecv():
        t = torch.full((10,), 9.0 if rank == 0 else 0.0, device=dev)
        (dist.isend(t, dst=1) if rank == 0 else dist.irecv(t, src=0)).wait()
        return bool((t == 9.0).all())

    def init_device_mesh_cuda():
        from torch.distributed.device_mesh import init_device_mesh
        m = init_device_mesh("cuda", (1, 2), mesh_dim_names=("data", "model"))
        t = torch.full((4,), float(rank + 1), device=dev)
        dist.all_reduce(t, group=m.get_group("model"))
        return bool((t == 3).all()) and m.get_local_rank("model") == rank

    return {f.__name__: f for f in (
        all_reduce, int32_all_reduce, all_gather, all_gather_into_tensor,
        broadcast, reduce_scatter_tensor, send_recv, isend_irecv,
        init_device_mesh_cuda)}


def _timings(dev) -> dict:
    out = {}
    for n in (64, 64 * 1024, 4 * 1024 * 1024):
        t = torch.ones(n, device=dev)
        for _ in range(3):
            dist.all_reduce(t)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(20):
            dist.all_reduce(t)
        torch.cuda.synchronize()
        out[f"all_reduce_ms_{n * 4}B"] = (time.perf_counter() - t0) / 20 * 1e3
    return out


def _worker(rank: int, world: int, store: str, out: str, name: str) -> None:
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=60))
    dev = torch.device("cuda", 0)
    if name == "timing":
        res = _timings(dev)
    else:
        try:
            ok = _cases(rank, world, dev)[name]()
            torch.cuda.synchronize()
            res = {name: "ok" if ok else "WRONG"}
        except Exception as e:  # noqa: BLE001 -- the probe records any failure
            res = {name: f"{type(e).__name__}: {str(e).splitlines()[0][:200]}"}
    if rank == 0:
        with open(out, "w") as f:
            json.dump(res, f)
    dist.destroy_process_group()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="build/gloo_probe.json")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("gloo_probe: CUDA is not available", file=sys.stderr)
        return 2
    print(sys.version, torch.__version__, torch.version.cuda,
          torch.cuda.device_count(), flush=True)
    names = list(_cases(0, 2, "cpu")) + ["timing"]
    results = {}
    with tempfile.TemporaryDirectory() as tmp:
        for i, name in enumerate(names):
            out = os.path.join(tmp, f"{i}.json")
            try:
                mp.spawn(_worker, args=(2, os.path.join(tmp, f"store{i}"), out,
                                        name), nprocs=2)
                with open(out) as f:
                    results.update(json.load(f))
            except mp.ProcessExitedException as e:
                results[name] = f"process died: {str(e)[:200]}"
            print(name, results.get(name, ""), flush=True)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(results, f, indent=1)
    print(json.dumps(results, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
