#!/usr/bin/env python3
"""K1 (TransE rank counts) on one NVIDIA GPU: what ptxas and the SASS say of
the current source, and its time against other sources of the same C entry
point and against its own "scalar" variant, in turns in one process.

    python3 k1_probe.py [--other build/k1_probe/a.cu ...]

Builds the current source as chip_smoke.py does and each `--other` source
with the port's nvcc flags into build/k1_probe/. Prints ptxas's registers,
spills and shared memory for each kernel, and the instruction mix of every
loop of the "tma" kernel that holds 200 FADDs or more (from `cuobjdump
-sass`: the instructions between a backward branch's target and the branch,
with the FADDs that take |.| as an operand modifier and the SASS stall
cycles of the loop). Holds every source to the plain version at 262,144
candidates, d 128 and 300; then at chip_smoke's Wikidata5M shape (Q 128,
4.8M candidates) and d 128, 300, 768 times, with CUDA events over 10
calls: current, each other, current again, the "scalar" variant (a view 4
bytes off), and reads the SM clock with the current kernel running.
"""

from __future__ import annotations

import argparse
import collections
import ctypes
import re
import subprocess
import sys
from pathlib import Path

import torch

import chip_smoke as cs
from blp_tpu_torch.ops import _cuda, transe_rank

REPS = 10   # calls per timed turn


def ptxas_lines(log: str) -> list[str]:
    """Each kernel's registers, shared memory and spills from ptxas -v."""
    out, name = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = "tma" if "tma_kernel" in m.group(1) else "scalar"
        elif name and ("registers" in line or "spill" in line):
            out.append(f"{name}: {line.strip()}")
    return out


def sass_loops(so: Path, kernel: str = "transe_rank_tma_kernel") -> list[str]:
    """The instruction mix of each loop of `kernel` with >= 200 FADDs."""
    sass = subprocess.run([str(Path(_cuda._nvcc()).with_name("cuobjdump")), "-sass",
                           str(so)], capture_output=True, text=True, check=True).stdout
    body = next(f for f in sass.split("Function : ")[1:] if kernel in f.split("\n", 1)[0])
    ins = []   # (address, opcode, operands, stall cycles)
    lines = body.splitlines()
    for line, nxt in zip(lines, lines[1:]):
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)([^;]*);", line)
        hi = re.search(r"/\* (0x[0-9a-f]+) \*/", nxt)
        if m and hi:
            ins.append((int(m.group(1), 16), m.group(3), m.group(4), (int(hi.group(1), 16) >> 41) & 0xF))
    out = []
    for addr, op, rest, _ in ins:
        target = re.search(r"0x([0-9a-f]+)", rest)
        if op.startswith("BRA") and target and int(target.group(1), 16) < addr:
            loop = [x for x in ins if int(target.group(1), 16) <= x[0] <= addr]
            ops = collections.Counter(x[1].split(".")[0] for x in loop)
            if ops["FADD"] < 200:
                continue
            absmod = sum("|" in x[2] for x in loop if x[1].startswith("FADD"))
            lds128 = sum(1 for x in loop if x[1].startswith("LDS.128"))
            out.append(f"loop {loop[0][0]:#x}-{addr:#x}: {len(loop)} instructions, "
                       f"{sum(x[3] for x in loop)} stall cycles; FADD {ops['FADD']} "
                       f"({100 * ops['FADD'] / len(loop):.1f}%, {absmod} with |.|), "
                       f"LDS.128 {lds128}; {ops.most_common(8)}")
    return out


def build_other(src: Path) -> ctypes.CDLL:
    out_dir = _cuda.BUILD_DIR.parent / "k1_probe"
    out_dir.mkdir(parents=True, exist_ok=True)
    out = out_dir / f"{src.stem}.so"
    done = subprocess.run([_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-o", str(out), str(src)],
                          capture_output=True, text=True)
    cs.require(done.returncode == 0, f"nvcc {src}:\n{done.stdout}{done.stderr}")
    for line in ptxas_lines(done.stdout):
        cs.log(f"  {src.stem} {line}")
    return ctypes.CDLL(str(out))


def other_call(lib: ctypes.CDLL, table, u, r, pos, num_valid: int):
    """One launch of another source's transe_rank_launch."""
    q, d = u.shape
    counts = torch.zeros((2, q), dtype=torch.int32, device=u.device)
    fn = lib.transe_rank_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 2 + [
        ctypes.c_int] * 2 + [ctypes.c_void_p] * 2
    r32 = r.reshape(q).contiguous()
    tp = pos.to(torch.int32).contiguous()
    _cuda.check(fn(table.data_ptr(), u.data_ptr(), r32.data_ptr(), tp.data_ptr(),
                   table.shape[0], num_valid, q, d, counts.data_ptr(),
                   torch.cuda.current_stream().cuda_stream), "other launch")
    return counts


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--other", type=Path, action="append", default=[])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("k1_probe: CUDA is not available", file=sys.stderr)
        return 2
    cs.log(f"card: {cs.card_line()}")
    _cuda.build_all()
    for line in ptxas_lines((_cuda.BUILD_DIR / "transe_rank.log").read_text()):
        cs.log(f"  current {line}")
    for line in sass_loops(_cuda.library_path("transe_rank")):
        cs.log(f"  current tma {line}")
    others = {src.stem: build_other(src) for src in args.other}

    n = 262_144
    for d in (cs.K1_D, 300):
        table, u, r, pos = cs.k1_inputs(n, n - 1000, seed=1, d=d)
        want = transe_rank.raw_counts_plain(table, u, r, pos, n - 1000)
        cs.require(torch.equal(transe_rank.raw_counts(table, u, r, pos, n - 1000), want),
                   f"the current source differs from the plain version at d={d}")
        for name, lib in others.items():
            cs.require(torch.equal(other_call(lib, table, u, r, pos, n - 1000), want),
                       f"{name} differs from the plain version at d={d}")
    cs.log("counts equal to the plain version's at d 128 and 300")

    n = cs.W5M_ENTITIES
    for d in (cs.K1_D, *cs.WORD_DIMS):
        table, u, r, pos = cs.k1_inputs(n, n, seed=3, d=d)
        bound = 2.0 * cs.K1_Q * n * d / cs.FP32_ADDS_PER_S * 1e3
        current = lambda: transe_rank.raw_counts(table, u, r, pos, n)  # noqa: E731
        turns = [("current", current),
                 *((name, lambda lib=lib: other_call(lib, table, u, r, pos, n))
                   for name, lib in others.items()),
                 ("current", current)]
        times = [(name, cs.cuda_ms(fn, reps=REPS)) for name, fn in turns]
        clock = cs.sm_clock_running(current, times[0][1])
        old = cs.offset_copy(table)
        del table
        times.append(("scalar", cs.cuda_ms(
            lambda: transe_rank.raw_counts(old, u, r, pos, n), reps=3)))
        del old
        torch.cuda.empty_cache()
        cs.log(f"d={d} (bound {bound:.3f} ms): " + "; ".join(
            f"{name} {ms:.3f} ms ({100 * bound / ms:.1f}%)" for name, ms in times)
            + f"; SM clock, max with the kernel running: {clock}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
