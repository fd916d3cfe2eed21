#!/usr/bin/env python3
"""K2 (packed attention) on one NVIDIA GPU: an earlier kernel source, the
current one and SDPA timed in turns in one process.

    mkdir -p build/k2_probe
    git show <commit>:blp_tpu_torch/csrc/packed_attention.cu > build/k2_probe/old.cu
    python3 k2_probe.py --old build/k2_probe/old.cu

Builds `--old` with the port's nvcc flags into build/k2_probe/ and the
current source as chip_smoke.py does. Then at two of chip_smoke's shapes,
K2_SHAPE at seg 32 and the Wikidata5M phase-1 chunk (6,144 rows at seg 64),
on its inputs (about 1 row in 8 ending in empty segments), it holds both
sources to the plain version and times, with CUDA events: old, new, new,
old, SDPA with the additive bias, and the new kernel with every segment
holding a real key.
"""

from __future__ import annotations

import argparse
import ctypes
import math
import subprocess
import sys
from pathlib import Path

import torch

import chip_smoke as cs
from blp_tpu_torch.ops import _cuda, packed_attention

REPS = 50   # calls per timed turn


def build_old(src: Path) -> ctypes.CDLL:
    out_dir = _cuda.BUILD_DIR.parent / "k2_probe"
    out_dir.mkdir(parents=True, exist_ok=True)
    out = out_dir / "old.so"
    done = subprocess.run([_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-o", str(out), str(src)],
                          capture_output=True, text=True)
    cs.require(done.returncode == 0, f"nvcc {src}:\n{done.stdout}{done.stderr}")
    return ctypes.CDLL(str(out))


def old_call(lib: ctypes.CDLL, q, k, v, mask, seg: int, scale: float):
    """One launch of the earlier source's packed_attention_launch."""
    b, nh, sp, hd = q.shape
    out = torch.empty((b, sp, nh * hd), dtype=torch.bfloat16, device=q.device)
    fn = lib.packed_attention_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_float,
                                                                 ctypes.c_void_p]
    _cuda.check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(),
                   out.data_ptr(), b, nh, sp, hd, seg, scale,
                   torch.cuda.current_stream().cuda_stream), "old launch")
    return out


def probe_at(old: ctypes.CDLL, b: int, seg: int) -> None:
    """Old and new against each other and against SDPA at b packed rows of
    Sp / seg segments."""
    _, nh, sp, hd = cs.K2_SHAPE
    q, k, v, mask = cs.k2_inputs(b, seed=4, seg=seg)
    scale = 1.0 / math.sqrt(hd)
    new = lambda: packed_attention.block_diag_attention(  # noqa: E731
        q, k, v, mask, seg=seg, scale=scale)
    want = packed_attention.block_diag_attention_plain(q, k, v, mask, seg=seg,
                                                       scale=scale).float()
    outs = {"old": old_call(old, q, k, v, mask, seg, scale), "new": new()}
    for tag, got in outs.items():
        err = (got.float() - want).abs().max().item()
        cs.log(f"{tag} vs plain at B={b} seg={seg}: max abs err {err:.3g}, "
               f"{100 * cs.over_one_ulp(got, want):.4f}% of outputs more than "
               f"1 bf16 ulp off")
        cs.require(err <= 2e-2, f"{tag} K2 differs from plain at B={b} seg={seg}")
    diff = (outs["old"].float() - outs["new"].float()).abs().max().item()
    cs.log(f"old vs new at B={b} seg={seg}: max abs diff {diff:.3g}")
    del want, outs
    times: dict[str, list[float]] = {}

    def timed(tag, fn):
        times.setdefault(tag, []).append(cs.cuda_ms(fn, reps=REPS, warmup=3))

    for tag in ("old", "new", "new", "old"):
        timed(tag, new if tag == "new" else
              (lambda: old_call(old, q, k, v, mask, seg, scale)))
    bias = packed_attention.block_bias(mask, seg).to(torch.bfloat16)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    timed("sdpa", lambda: sdpa(q, k, v, attn_mask=bias, scale=scale))
    full = mask.clone()
    full.view(b, -1, seg)[..., 0] = 1.0   # every segment with a real key
    timed("new, no empty segment",
          lambda: packed_attention.block_diag_attention(q, k, v, full, seg=seg,
                                                        scale=scale))
    bound = (2.0 * 4 * b * nh * sp * hd + 4.0 * b * sp) / cs.HBM_BYTES_PER_S * 1e3
    cs.log(f"K2 at B={b} nh={nh} Sp={sp} hd={hd} seg={seg}, ms per call "
           f"(CUDA events, {REPS} calls each, in turns); bytes bound "
           f"{bound:.4f} ms:")
    for tag, ts in times.items():
        cs.log(f"  {tag}: {', '.join(f'{t:.4f}' for t in ts)} "
               f"(best {min(ts):.4f} = {100 * bound / min(ts):.1f}% of bound)")
    del q, k, v, mask, bias, full
    torch.cuda.empty_cache()


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--old", type=Path, required=True)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("k2_probe: CUDA is not available", file=sys.stderr)
        return 2
    cs.log(f"card: {cs.card_line()}")
    _cuda.build_all()
    old = build_old(args.old)

    for b, seg in ((cs.K2_SHAPE[0], cs.SEG), (cs.W5M_K2_ROWS, cs.W5M_SEG)):
        probe_at(old, b, seg)
    return 0


if __name__ == "__main__":
    sys.exit(main())
