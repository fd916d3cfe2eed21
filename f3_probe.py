#!/usr/bin/env python3
"""The attention softmax chain and the dropout masks on one NVIDIA GPU: what
they cost the main path, for the tree at --root (this checkout by default,
or a `git archive` of another commit unpacked under build/, to compare two
commits in one process launch each).

    mkdir -p build/parent && git archive <commit> | tar -x -C build/parent
    python3 f3_probe.py --root build/parent --out build/f3_probe/parent.json
    python3 f3_probe.py --out build/f3_probe/change.json

On the tree at --root it measures, with torch.profiler's device time unless
named otherwise:
(1) the op-by-op chain (f32 cast, divide by sqrt(head_dim), add the mask
    bias, torch.softmax, bf16 cast, `_rng_dropout`) at the W5M train shape
    (1,024 packed rows of two 64-token segments, 12 heads, 128 x 128, bf16
    logits), forward and forward+backward, with 32- and 8-bit masks, one
    torch mask draw alone where the tree draws its masks with torch, and F3
    (ops/attn_softmax.py) the same way where the tree has it;
(2) chip_smoke's phase 6 (c) W5M step (B 1,024, L 64, K 64, remat=8): six
    steps' wall ms, peak memory, and one step's device time by kernel name,
    with its device launches, those of F2's backward (add_ln_bwd, and
    column_sum where the tree has it), and the launches and device ms of
    torch's generator, of `where`, of the scalar compares and of the copies
    summed;
(3) phase 4's encode of 4,096 entities at L 32 with and without K2
    (`fused_attention`), best of 5, with its kernels;
(4) `bench --w5m`'s point through chip_smoke's `w5m_point` (skip with
    --skip-bench);
(5) the flagship step (phase 6 (b): B 64, L 32): ms a step over 10 steps and
    one step's device launches;
(6) F2 and F3 through chip_smoke's timing functions (the tree's own
    kernels): at the W5M train shape F2's forward without dropout, and with
    8- and 32-bit masks where its F2 takes them, F3's forward and backward
    with 8- and 32-bit masks and without dropout; F3's inference variant at
    the W5M encode chunk (6,144 rows) and at L 32 (1,024 rows);
(7) the copies of (2)'s step by source: one step profiled with shapes and
    Python stacks recorded, each copy kernel charged (chip_smoke's
    `copies_by_shape`, so a tree from PR 15 on) to the op that launched it,
    named by that op's chain of parent ops (an autograd node names a
    backward's source) and the innermost frames of this repository;
(8) F1 (ops/fused_layer.py `bias_act`) through chip_smoke's timing functions
    at the W5M train shapes and the encode chunk's, and the cotangent of a
    head-major q (B, nh, S, hd) and of k (the same shape, strided as the
    q k^T product's backward leaves it) turned into dh (B, S, H) and db:
    the tree's kernel with the head-major layout where it takes one, else
    the parent's path (the permute copy, then the kernel's db), with the
    registers ptxas gives the tree's F1 kernels.
(9) F3's forward without dropout at 1,024 rows with 32- and 64-token
    segments, logits rounded to bf16 (the inference variant) and not,
    and the inference variant at 6,144 rows of 32-token segments.
(10) F2's forward (`add_layer_norm_forward` of csrc/fused_layer.cu) of the
    tree at --root against that of the tree at --f2-parent, whose source is
    built here with the same nvcc flags: both called through ctypes on the
    same inputs at the W5M train step's 131,072 x 768 (bf16 x + r with the
    sum written, without it, with 8-, 16- and 32-bit masks; the f32
    embedding sum alone to bf16) and the encode chunk's 786,432 rows, timed
    in turns (CUDA events over 20 calls, parent, tree, tree, parent, the
    better read of each), y, s, mean and rstd compared bit for bit (the
    largest difference where they differ), and the registers and spills
    ptxas gives each tree's bf16 forward and backward kernels; then F2's
    backward (`add_layer_norm_backward`, the parent's with its own C
    signature: before the one-launch backward it took no ticket buffer) the
    same way at 131,072 x 768, bf16 with 8- and 32-bit masks and without,
    and the embedding LayerNorm's (f32 sum, bf16 cotangent): ds, dr,
    dscale and dbias compared bit for bit (`bit_equal`), and each side also
    timed a call at a time right after a kernel that streams 256 MB
    (`ms_after_flush`: L2 as a training step leaves it, in turns).
Prints a summary and writes every table to --out (JSON). `--parts` picks
some of them (default: all but f2, which needs --f2-parent).

    python3 f3_probe.py --parts f2 --f2-parent build/parent
"""

from __future__ import annotations

import argparse
import dataclasses
import inspect
import json
import math
import os
import sys
import time

import torch

B, NH, S, HD = 1024, 12, 128, 64
#: Kernel-name groups of the W5M step summed in (2).
GROUPS = {"torch RNG": ("distribution_", "randint", "bernoulli"),
          "where": ("where_kernel",), "scalar compare": ("compare_scalar",),
          "copies": ("direct_copy", "bfloat16_copy")}
PARTS = ("chain", "w5m", "encode", "bench", "flagship", "kernels", "copies", "f1",
         "inference", "f2")
#: (10)'s cases: (rows, nbits or None, x + r (else x alone, f32), sum written).
F2_CASES = {"sum": (131_072, None, True, True), "no_sum": (131_072, None, True, False),
            "drop8": (131_072, 8, True, True), "drop16": (131_072, 16, True, True),
            "drop32": (131_072, 32, True, True), "emb": (131_072, None, False, False),
            "encode": (786_432, None, True, False)}
#: (10)'s backward cases: (rows, nbits or None, dtype of the sum s).
F2_BWD_CASES = {"bwd_drop8": (131_072, 8, "bf16"), "bwd_drop32": (131_072, 32, "bf16"),
                "bwd_none": (131_072, None, "bf16"), "bwd_emb": (131_072, None, "f32")}
def kernel_table(fn) -> tuple[float, list]:
    """(wall ms, [(kernel name, device ms, count)] by device time) of one
    call of fn under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    return wall_ms, sorted(((e.key, e.self_device_time_total / 1e3, e.count)
                            for e in prof.key_averages()
                            if e.device_type == torch.autograd.DeviceType.CUDA
                            and e.self_device_time_total > 0), key=lambda k: -k[1])


def chain(l, mask_bias, nbits):
    """The layer's attention chain before F3, op by op."""
    x = l.to(torch.float32) / math.sqrt(HD) + mask_bias
    p = torch.softmax(x, dim=-1).to(torch.bfloat16)
    return bert._rng_dropout(p, 1234, 0.1, nbits)


def chain_costs(res: dict) -> None:
    """(1)."""
    g = torch.Generator(device="cuda").manual_seed(0)
    l = (4 * torch.randn((B, NH, S, S), generator=g, device="cuda")).to(torch.bfloat16)
    keys = (torch.rand((B // 2, S), generator=g, device="cuda") > 0.3).float()
    idx = torch.arange(S, device="cuda") // 64
    visible = (idx[:, None] == idx[None, :])[None] & (keys[:, None, :] > 0)
    mask_bias = torch.where(visible, 0.0, -10000.0)[:B // 2, None]
    mask_bias = torch.cat([mask_bias, mask_bias])
    gy = torch.randn((B, NH, S, S), generator=g, device="cuda").to(torch.bfloat16)

    def fwd_bwd(fn):
        def run():
            ll = l.detach().requires_grad_()
            torch.autograd.grad(fn(ll), ll, gy)
        return run

    for nbits in (32, 8):
        with torch.no_grad():
            fwd_ms, fwd_n, fwd_names = cs.device_ms(lambda: chain(l, mask_bias, nbits),
                                                    reps=3)
        fb_ms, fb_n, fb_names = cs.device_ms(
            fwd_bwd(lambda ll: chain(ll, mask_bias, nbits)), reps=3)
        keep_ms = None
        if hasattr(bert, "_site_keep"):      # a tree that draws with torch
            keep_ms, _, _ = cs.device_ms(lambda: bert._site_keep(
                1234, 0.1, nbits, l.shape, "cuda", None), reps=3)
        res[f"chain{nbits}"] = {"fwd_ms": fwd_ms, "fwd_launches": fwd_n,
                                "fwd_bwd_ms": fb_ms, "fwd_bwd_launches": fb_n,
                                "mask_draw_ms": keep_ms, "fwd_names": fwd_names,
                                "fwd_bwd_names": fb_names}
        print(f"op-by-op chain at {B}x{NH}x{S}x{S}, {nbits}-bit masks: forward "
              f"{fwd_ms:.3f} ms ({fwd_n:g} launches), forward+backward {fb_ms:.3f} "
              f"ms ({fb_n:g}); one torch mask draw {keep_ms} ms", flush=True)
        if F3 is None:
            continue
        drop = (1234, 0.1, nbits, None)

        def f3(ll):
            return F3.attn_softmax(ll, mask_bias, math.sqrt(HD), torch.bfloat16,
                                   False, drop)
        with torch.no_grad():
            f_ms, _, _ = cs.device_ms(lambda: f3(l), reps=3)
        f_fb, _, _ = cs.device_ms(fwd_bwd(f3), reps=3)
        res[f"f3_{nbits}"] = {"fwd_ms": f_ms, "fwd_bwd_ms": f_fb}
        print(f"  F3 (its masks included): forward {f_ms:.3f} ms, "
              f"forward+backward {f_fb:.3f} ms", flush=True)


def w5m_step(res: dict, data_dir: str) -> None:
    """(2)."""
    cfg, params = cs.train_model(12, remat=8)
    opt = training.make_optimizer(5e-5, 1000)
    state = opt.init(params)
    step = training.make_train_step(cfg, opt, batch_size=1024, num_negatives=64,
                                    device="cuda")
    batches = cs.train_batches(data_dir, 64, 1024, 3)
    torch.cuda.reset_peak_memory_stats()
    times = []
    for i, batch in enumerate(batches * 2):
        (params, state, _), s = cs.wall(lambda: step(params, state, (0, i), batch))  # noqa: B023
        times.append(s * 1e3)
    peak = torch.cuda.max_memory_allocated()
    wall_ms, ks = kernel_table(lambda: step(params, state, (0, 9), batches[0]))
    busy = sum(k[1] for k in ks)
    groups = {g: [sum(ms for n, ms, _ in ks if any(p in n for p in pats)),
                  sum(c for n, _, c in ks if any(p in n for p in pats))]
              for g, pats in GROUPS.items()}
    launches = sum(c for _, _, c in ks)
    f2_bwd = {k: [sum(ms for n, ms, _ in ks if k in n), sum(c for n, _, c in ks if k in n)]
              for k in ("add_ln_bwd", "column_sum")}
    res["w5m_step"] = {"ms": times, "peak_gib": peak / 2**30, "prof_wall_ms": wall_ms,
                       "busy_ms": busy, "launches": launches, "groups": groups,
                       "f2_backward": f2_bwd,
                       "kernels": [(n[:300], ms, c) for n, ms, c in ks]}
    print(f"W5M step remat=8: {[round(t, 1) for t in times]} ms, peak "
          f"{peak / 2**30:.2f} GiB; profiled wall {wall_ms:.1f} busy {busy:.1f}; "
          f"{launches} device launches; F2's backward kernels (ms, launches) {f2_bwd}; "
          + ", ".join(f"{g} {ms:.2f} ms x{c}" for g, (ms, c) in groups.items()),
          flush=True)
    for n, ms, c in ks[:30]:
        print(f"  {ms:9.2f} ms x{c:<6d} {n[:150]}", flush=True)


def encodes(res: dict, data_dir: str) -> None:
    """(3)."""
    tok = WordPieceTokenizer(os.path.join(data_dir, "vocab.txt"))
    texts = [ln.split("\t")[1] for ln in open(
        os.path.join(data_dir, "entity2text.txt"), encoding="utf-8").read().splitlines()]
    ids, mask = tok.batch_encode(texts, cs.SEG)
    cfg, params = cs.make_model(num_relations=12)
    for fused in (True, False):
        c = dataclasses.replace(cfg, encoder=dataclasses.replace(
            cfg.encoder, fused_attention=fused))
        srv = serve.LinkPredictor(params=params, cfg=c, tokenizer=tok,
                                  max_len=cs.SEG, device="cuda")
        srv._encode(srv.params, ids, mask)
        ts = [cs.wall(lambda: srv._encode(srv.params, ids, mask))[1]  # noqa: B023
              for _ in range(5)]
        _, ks = kernel_table(lambda: srv._encode(srv.params, ids, mask))  # noqa: B023
        busy = sum(k[1] for k in ks)
        res[f"encode_fused_{fused}"] = {
            "ms": [t * 1e3 for t in ts], "entities_per_s": len(texts) / min(ts),
            "busy_ms": busy, "kernels": [(n[:300], ms, c) for n, ms, c in ks[:40]]}
        print(f"encode 4,096 at L 32 fused_attention={fused}: best "
              f"{min(ts) * 1e3:.2f} ms = {len(texts) / min(ts):,.0f} entities/s; busy "
              f"{busy:.2f} ms", flush=True)
        for n, ms, cnt in ks[:12]:
            print(f"  {ms:8.3f} ms x{cnt:<5d} {n[:150]}", flush=True)


def flagship(res: dict, data_dir: str) -> None:
    """(5)."""
    cfg, params = cs.train_model(12)
    opt = training.make_optimizer(2e-5, 1000)
    state = opt.init(params)
    step = training.make_train_step(cfg, opt, batch_size=64, num_negatives=64,
                                    device="cuda")
    batches = cs.train_batches(data_dir, cs.SEG, 64, 13)
    for i in range(3):
        params, state, _ = step(params, state, (0, i), batches[i])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(3, 13):
        params, state, loss = step(params, state, (0, i), batches[i])
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / 10
    wall_ms, ks = kernel_table(lambda: step(params, state, (0, 13), batches[0]))
    n = sum(c for _, _, c in ks)
    res["flagship"] = {"ms": ms, "launches": n, "prof_wall_ms": wall_ms,
                       "busy_ms": sum(k[1] for k in ks)}
    print(f"flagship step (B 64, L 32): {ms:.2f} ms a step over 10; one step "
          f"{n} device launches, busy {res['flagship']['busy_ms']:.1f} of "
          f"{wall_ms:.1f} ms", flush=True)


def kernels(res: dict) -> None:
    """(6)."""
    out = {"f3_drop8": cs._time_f3_at(B, 64, False, 8),
           "f3_drop32": cs._time_f3_at(B, 64, False, 32),
           "f3_no_dropout": cs._time_f3_at(B, 64, False, None),
           "f3_encode": cs._time_f3_at(cs.W5M_K2_ROWS, 64, True, None),
           "f3_l32": cs._time_f3_at(B, cs.SEG, True, None),
           "f3_bwd_drop8": cs._time_f3_backward_at(B, 64, 8),
           "f3_bwd_drop32": cs._time_f3_backward_at(B, 64, 32),
           "f3_bwd_no_dropout": cs._time_f3_backward_at(B, 64, None),
           "f2": cs._time_f2_at(cs.W5M_TOKENS)}
    if "nbits" in inspect.signature(cs._time_f2_at).parameters:
        out["f2_drop8"] = cs._time_f2_at(cs.W5M_TOKENS, 8)
        out["f2_drop32"] = cs._time_f2_at(cs.W5M_TOKENS, 32)
    res["kernels"] = out
    for k, v in out.items():
        row = f", row design {v['row_ms']:.4f}" if "row_ms" in v else ""
        print(f"{k}: {v['ms']:.4f} ms{row} (plain {v['plain_ms']:.3f}, library "
              f"{v['library_ms']:.4f}, bound {v['bound_ms']:.4f} by {v['bound_by']}; "
              f"{v.get('with_mask_draw_ms', '-')} with a torch mask draw)", flush=True)


def copy_source(e) -> str:
    """The source of op e, which launched a copy: its chain of parent ops,
    innermost first (an autograd node, "evaluate_function: <Node>", names a
    backward's source), and the innermost frames of this repository's
    packages on the Python stack of the nearest op that has one."""
    chain, frames, p = [], [], e
    while p is not None:     # python_function events carry the stack
        if ".py(" in p.name:
            if "blp_tpu_torch" in p.name or "chip_smoke" in p.name:
                frames.append(p.name.split("blp_tpu_torch/")[-1])
        elif not p.name.startswith("<built-in"):
            chain.append(p.name)
        frames.extend(f.split("blp_tpu_torch/")[-1] for f in (p.stack or [])
                      if "blp_tpu_torch" in f)
        p = p.cpu_parent
    node = next((n for n in chain if "evaluate_function" in n), None)
    names = chain[:4] + ([node] if node and node not in chain[:4] else [])
    return " < ".join(names) + " | at " + " | ".join(frames[:3])


def copy_sources(fn, top: int = 30) -> list:
    """[(source, input shapes, device ms, launches)] of the copy kernels one
    call of fn launches, by device time (`copy_source`), the rest summed."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True, with_stack=True) as prof:
        fn()
        torch.cuda.synchronize()
    out = cs.copies_by_shape(prof, copy_source)
    return out[:top] + ([("(the rest)", "", sum(r[2] for r in out[top:]),
                          sum(r[3] for r in out[top:]))] if out[top:] else [])


def copies(res: dict, data_dir: str) -> None:
    """(7)."""
    cfg, params = cs.train_model(12, remat=8)
    opt = training.make_optimizer(5e-5, 1000)
    state = opt.init(params)
    step = training.make_train_step(cfg, opt, batch_size=1024, num_negatives=64,
                                    device="cuda")
    batches = cs.train_batches(data_dir, 64, 1024, 3)
    for i, batch in enumerate(batches):
        params, state, _ = step(params, state, (0, i), batch)
    rows = copy_sources(lambda: step(params, state, (0, 9), batches[0]))
    res["w5m_copies"] = rows
    print(f"W5M step remat=8, copies by source: {sum(r[2] for r in rows):.2f} ms x"
          f"{sum(r[3] for r in rows)}", flush=True)
    for src, shapes, ms, n in rows:
        print(f"  {ms:8.3f} ms x{n:<4d} {src[:400]}\n      shapes {shapes[:160]}",
              flush=True)


def f1(res: dict) -> None:
    """(8)."""
    at, bwd_at = cs._time_f1_at, cs._time_f1_backward_at
    heads = "head_dim" in inspect.signature(at).parameters
    out = {"fwd_none": at("none", cs.W5M_TOKENS, cs.BERT_H),
           "fwd_poly": at("poly", cs.W5M_TOKENS, cs.BERT_I),
           "fwd_poly_encode": at("poly", cs.ENCODE_TOKENS, cs.BERT_I),
           "bwd_poly": bwd_at("poly", cs.W5M_TOKENS, cs.BERT_I),
           "bwd_none": bwd_at("none", cs.W5M_TOKENS, cs.BERT_H)}
    if heads:
        out["fwd_none_heads"] = at("none", cs.W5M_TOKENS, cs.BERT_H, head_dim=HD)
    bf = torch.bfloat16
    g = torch.Generator(device="cuda").manual_seed(52)
    gq = torch.randn((B, NH, S, HD), generator=g, device="cuda").to(bf)
    # k's cotangent: q k^T's backward leaves it (B, nh, hd, S) in memory.
    gk = torch.randn((B, NH, HD, S), generator=g, device="cuda").to(bf).transpose(-1, -2)
    b = torch.randn(NH * HD, generator=g, device="cuda")
    kern = fused_layer._bias_act_backward_kernel
    if "head_dim" in inspect.signature(kern).parameters:
        call = lambda gg: kern(gg, None, b, "none", bf, True, head_dim=HD)  # noqa: E731
    else:     # the parent's path: autograd's permute, a copy, then db
        call = lambda gg: kern(gg.permute(0, 2, 1, 3).reshape(B, S, NH * HD),  # noqa: E731
                               None, b, "none", bf, True)
    for name, gg in (("q", gq), ("k", gk)):
        dh, db = call(gg)
        want = gg.permute(0, 2, 1, 3).reshape(B, S, NH * HD)
        ok = torch.equal(dh, want) and cs.sum_close(db, want.float().sum((0, 1)))[0]
        ms = cs.cuda_ms(lambda: call(gg), reps=20, warmup=3)  # noqa: B023
        dev_ms, n, names = cs.device_ms(lambda: call(gg), reps=5)  # noqa: B023
        out[f"bwd_heads_{name}"] = {"ms": ms, "device_ms": dev_ms, "launches": n,
                                    "kernels": names, "equal": ok}
        del dh, db, want
    del gq, gk
    torch.cuda.empty_cache()
    log_path = _cuda.BUILD_DIR / "fused_layer.log"
    if log_path.exists():
        out["registers"] = f1_registers(log_path.read_text())
        print(f"F1's kernels (bf16 -> bf16): registers {out['registers']}", flush=True)
    res["f1"] = out
    for k, v in out.items():
        if k == "registers":
            continue
        extra = (f"bound {v['bound_ms']:.4f} ms, plain {v['plain_ms']:.3f}, library "
                 f"{v['library_ms']:.4f}" if "bound_ms" in v else
                 f"device {v['device_ms']:.4f} ms in {v['launches']:g} launches, "
                 f"dh and db right: {v['equal']}; {v['kernels']}")
        print(f"F1 {k}: {v['ms']:.4f} ms; {extra}", flush=True)


def f1_registers(log_text: str) -> list:
    """[(kernel, registers)] of F1's bf16 -> bf16 kernels in an nvcc -Xptxas
    -v log."""
    out, name = [], None
    for line in log_text.splitlines():
        if "Compiling entry" in line:
            name = line.split("'")[1] if "bias_act" in line and "13__nv_bfloat16S1_" in line else None
        elif name and "registers" in line:
            short = name[name.index("bias_act"):].split("PK")[0].replace("13__nv_bfloat16S1_", "")
            out.append((short, int(line.split("Used")[1].split("registers")[0])))
            name = None
    return out


def inference(res: dict) -> None:
    """(9)."""
    out = {f"seg{seg}_{'round' if rl else 'train'}": cs._time_f3_at(B, seg, rl, None)
           for seg in (32, 64) for rl in (True, False)}
    out["seg32_round_6144"] = cs._time_f3_at(cs.W5M_K2_ROWS, 32, True, None)
    res["inference"] = out
    for k, v in out.items():
        row = f", row design {v['row_ms']:.4f}" if "row_ms" in v else ""
        print(f"f3 {k}: {v['ms']:.4f} ms{row} (bound {v['bound_ms']:.4f})", flush=True)


def f2_library(parent_root: str):
    """The parent tree's F2 entry points: its csrc/fused_layer.cu built with
    this tree's nvcc flags into <parent>/build/f3_probe/ (once), its forward
    and backward bound with their signatures (`old_backward`: the parent's
    backward takes no ticket buffer), and its ptxas log."""
    import ctypes
    import subprocess
    src = os.path.join(parent_root, "blp_tpu_torch", "csrc", "fused_layer.cu")
    out_dir = os.path.join(parent_root, "build", "f3_probe")
    lib, log = os.path.join(out_dir, "fused_layer.so"), os.path.join(out_dir, "fused_layer.log")
    if not os.path.exists(lib):       # built once a parent tree (a git archive)
        os.makedirs(out_dir, exist_ok=True)
        done = subprocess.run([_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-o", lib, src],
                              capture_output=True, text=True, timeout=900)
        if done.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src}:\n{done.stdout}{done.stderr}")
        with open(log, "w") as f:
            f.write(done.stdout + done.stderr)
    with open(src) as f:
        old_backward = "column_sum(" in f.read()
    cdll = ctypes.CDLL(lib)
    fwd, bwd = cdll.add_layer_norm_forward, cdll.add_layer_norm_backward
    fwd.restype, fwd.argtypes = ctypes.c_int, fused_layer._SIGNATURES["add_layer_norm_forward"]
    bwd.restype = ctypes.c_int
    # Before the one-launch backward (add_ln_bwd, then column_sum) the entry
    # took no ticket buffer and no length of it.
    p, i = ctypes.c_void_p, ctypes.c_int
    bwd.argtypes = ([p] * 9 + [ctypes.c_longlong] + [i] * 4 + fused_layer._DROP + [p]
                    if old_backward else fused_layer._SIGNATURES["add_layer_norm_backward"])
    with open(log) as f:
        return fwd, bwd, old_backward, f.read()


def f2_registers(log_text: str, kernel: str = "add_ln_fwd") -> list:
    """[(kernel, registers, spill line)] of the bf16 -> bf16 F2 kernels
    named `kernel` in an nvcc -Xptxas -v log."""
    out, name, spill = [], None, ""
    for line in log_text.splitlines():
        if "Compiling entry" in line:
            name = line.split("'")[1] if kernel in line else None
            spill = ""
        elif name and "spill" in line:
            spill = line.split(":", 1)[-1].strip()
        elif name and "registers" in line:
            out.append((name, int(line.split("Used")[1].split("registers")[0]), spill))
            name = None
    return [o for o in out if "13__nv_bfloat16S" in o[0]]


def ms_after_flush(fn, flush, reps: int = 20) -> float:
    """Mean device ms of fn, each call timed alone with CUDA events right
    after `flush` (a kernel that streams a buffer larger than L2), as a
    training step finds L2 after other kernels: no back-to-back reuse."""
    fn()
    times = []
    for _ in range(reps):
        flush()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return sum(times) / reps


def f2_backward(parent_bwd, old_backward: bool) -> dict:
    """(10), the backward: each F2_BWD_CASES case through the parent's entry
    and the tree's, timed in turns, outputs compared bit for bit."""
    bf, w = torch.bfloat16, cs.BERT_H
    tree_bwd = fused_layer._bound("add_layer_norm_backward")
    out = {}
    for name, (rows, nbits, s_name) in F2_BWD_CASES.items():
        g = torch.Generator(device="cuda").manual_seed(91)
        s_dt = bf if s_name == "bf16" else torch.float32
        s = (1.0 + torch.randn((rows, w), generator=g, device="cuda")).to(s_dt)
        mean = s.float().mean(-1)
        rstd = torch.rsqrt(s.float().var(-1, unbiased=False) + 1e-12)
        scale = 1.0 + 0.1 * torch.randn(w, generator=g, device="cuda")
        gy = torch.randn((rows, w), generator=g, device="cuda").to(bf)
        drop = fused_layer._drop_args(None if nbits is None else (12, 0.1, nbits, None),
                                      (rows, w))
        chunk = fused_layer.chunk_rows(rows)
        n_chunks = -(-rows // chunk)

        def outputs():
            return (torch.empty((rows, w), dtype=s_dt, device="cuda"),
                    None if nbits is None else torch.empty((rows, w), dtype=s_dt,
                                                           device="cuda"),
                    torch.empty(2 * w, device="cuda"),
                    torch.empty((n_chunks, 2 * w), device="cuda"))

        def call(fn, o, tree: bool):
            head = (gy.data_ptr(), s.data_ptr(), mean.data_ptr(), rstd.data_ptr(),
                    scale.data_ptr(), o[0].data_ptr(), None if o[1] is None else
                    o[1].data_ptr(), o[3].data_ptr(), o[2].data_ptr())
            dts = (fused_layer._DTYPES[s_dt], fused_layer._DTYPES[bf], chunk)
            stream = torch.cuda.current_stream().cuda_stream
            if tree or not old_backward:
                state = fused_layer._ticket_buffer("f2", s.device, fused_layer.F2_STATE)
                args = (*head, state.data_ptr(), rows, w, *dts, state.numel(), *drop,
                        stream)
            else:
                args = (*head, rows, w, *dts, *drop, stream)
            return lambda: fused_layer._cuda.check(fn(*args), "add_layer_norm_backward")

        o_par, o_tree = outputs(), outputs()
        call(parent_bwd, o_par, False)()
        call(tree_bwd, o_tree, True)()
        torch.cuda.synchronize()
        pairs = [(k, a, b) for k, a, b in zip(("ds", "dr", "dscale_dbias"), o_tree, o_par)
                 if a is not None]
        diffs = {k: (a.float() - b.float()).abs().max().item() for k, a, b in pairs}
        equal = all(torch.equal(a, b) for _, a, b in pairs)
        par_ms, tree_ms = cs.cuda_ms_in_turns(call(parent_bwd, o_par, False),
                                              call(tree_bwd, o_tree, True))
        big = torch.empty(64 << 20, device="cuda")           # 256 MB, 5x L2
        flush = lambda: big.add_(1.0)  # noqa: E731
        flushed = [ms_after_flush(f, flush) for f in (
            call(parent_bwd, o_par, False), call(tree_bwd, o_tree, True),
            call(tree_bwd, o_tree, True), call(parent_bwd, o_par, False))]
        del big
        # g read (bf16), s read and ds (and dr) written; mean and rstd read;
        # scale read, dscale and dbias written
        nbytes = ((2 + s.element_size() * (2 if nbits is None else 3)) * rows * w
                  + 8.0 * rows + 12.0 * w)
        out[name] = {"ms": tree_ms, "parent_ms": par_ms, "bit_equal": equal,
                     "max_diff": diffs, "ms_after_flush": min(flushed[1:3]),
                     "parent_ms_after_flush": min(flushed[0], flushed[3]),
                     **cs._bound(nbytes, (cs.F2_BWD_OPS + cs._philox_ops(nbits)) * rows * w),
                     "shape": f"{rows:,} x {w} {s_name} s, bf16 g"
                              f"{'' if nbits is None else f', dr drop{nbits}'}"}
        del s, gy, o_par, o_tree
        torch.cuda.empty_cache()
    return out


def f2(res: dict, parent_root: str) -> None:
    """(10)."""
    parent_fn, parent_bwd, old_backward, parent_log = f2_library(parent_root)
    tree_fn = fused_layer._bound("add_layer_norm_forward")
    bf, eps, w = torch.bfloat16, 1e-12, cs.BERT_H
    out = {}
    for name, (rows, nbits, with_r, keep_sum) in F2_CASES.items():
        g = torch.Generator(device="cuda").manual_seed(90)
        x_dt = bf if with_r else torch.float32
        x = (1.0 + torch.randn((rows, w), generator=g, device="cuda")).to(x_dt)
        r = (0.5 * torch.randn((rows, w), generator=g, device="cuda")).to(bf) if with_r else None
        scale = 1.0 + 0.1 * torch.randn(w, generator=g, device="cuda")
        bias = 0.1 * torch.randn(w, generator=g, device="cuda")
        drop = fused_layer._drop_args(None if nbits is None else (11, 0.1, nbits, None),
                                      (rows, w))

        def outputs():
            return (torch.empty((rows, w), dtype=bf, device="cuda"),
                    torch.empty((rows, w), dtype=x_dt, device="cuda") if keep_sum else None,
                    torch.empty(rows, device="cuda"), torch.empty(rows, device="cuda"))

        def call(fn, o):
            return lambda: fused_layer._cuda.check(fn(
                x.data_ptr(), None if r is None else r.data_ptr(), scale.data_ptr(),
                bias.data_ptr(), o[0].data_ptr(), None if o[1] is None else o[1].data_ptr(),
                o[2].data_ptr(), o[3].data_ptr(), rows, w, fused_layer._DTYPES[x_dt],
                fused_layer._DTYPES[bf], eps, *drop,
                torch.cuda.current_stream().cuda_stream), "add_layer_norm_forward")

        o_par, o_tree = outputs(), outputs()
        call(parent_fn, o_par)()
        call(tree_fn, o_tree)()
        torch.cuda.synchronize()
        diffs = {k: (a.float() - b.float()).abs().max().item()
                 for k, a, b in zip(("y", "s", "mean", "rstd"), o_tree, o_par)
                 if a is not None}
        equal = all(torch.equal(a, b) for a, b in zip(o_tree, o_par) if a is not None)
        par_ms, tree_ms = cs.cuda_ms_in_turns(call(parent_fn, o_par), call(tree_fn, o_tree))
        # x (and r) read, y (and s) written; mean and rstd; scale and bias
        nbytes = ((x.element_size() * (2 if keep_sum else 1) + 2
                   + (r.element_size() if with_r else 0)) * rows * w + 8.0 * (rows + w))
        out[name] = {"ms": tree_ms, "parent_ms": par_ms, "bit_equal": equal,
                     "max_diff": diffs,
                     **cs._bound(nbytes, (cs.F2_OPS + cs._philox_ops(nbits)) * rows * w),
                     "shape": f"{rows:,} x {w} {'x+r' if with_r else 'x f32'}"
                              f"{'' if nbits is None else f' drop{nbits}'}"
                              f"{', sum written' if keep_sum else ''} -> bf16"}
        del x, r, o_par, o_tree
        torch.cuda.empty_cache()
    out.update(f2_backward(parent_bwd, old_backward))
    tree_log = _cuda.BUILD_DIR / "fused_layer.log"
    tree_text = tree_log.read_text() if tree_log.exists() else ""
    out["registers"] = {side: f2_registers(text) + f2_registers(text, "add_ln_bwd")
                        for side, text in (("tree", tree_text), ("parent", parent_log))}
    res["f2"] = out
    for k, v in out.items():
        if k == "registers":
            continue
        print(f"F2 {k} ({v['shape']}): {v['ms']:.4f} ms against the parent's "
              f"{v['parent_ms']:.4f} ({100 * v['bound_ms'] / v['ms']:.1f}% and "
              f"{100 * v['bound_ms'] / v['parent_ms']:.1f}% of the bound "
              f"{v['bound_ms']:.4f} by {v['bound_by']}); bit-equal {v['bit_equal']}, "
              f"largest differences {v['max_diff']}"
              + (f"; each call after a 256 MB stream: {v['ms_after_flush']:.4f} against "
                 f"{v['parent_ms_after_flush']:.4f}" if "ms_after_flush" in v else ""),
              flush=True)
    for side, regs in out["registers"].items():
        for kname, n, spill in regs:
            print(f"F2 registers, {side}: {n} ({spill}) {kname[:120]}", flush=True)


def _import(root: str) -> None:
    """The modules of the tree at `root`, as this module's globals."""
    global cs, serve, training, write_synth_dataset, WordPieceTokenizer, bert
    global _cuda, F3, fused_layer
    sys.path.insert(0, root)
    os.chdir(root)
    import chip_smoke as cs
    from blp_tpu_torch import serve, training
    from blp_tpu_torch.data.synth import write_synth_dataset
    from blp_tpu_torch.data.tokenizers import WordPieceTokenizer
    from blp_tpu_torch.models import bert
    from blp_tpu_torch.ops import _cuda, fused_layer
    try:
        from blp_tpu_torch.ops import attn_softmax as F3
    except ImportError:     # a tree from before F3
        F3 = None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.abspath(__file__)),
                    help="the tree to measure (default: this checkout)")
    ap.add_argument("--out", default="build/f3_probe/f3_probe.json",
                    help="JSON file for the tables (relative to the working "
                         "directory)")
    ap.add_argument("--skip-bench", action="store_true")
    ap.add_argument("--parts", default=",".join(p for p in PARTS if p != "f2"),
                    help=f"comma-separated parts to run, of {','.join(PARTS)}")
    ap.add_argument("--f2-parent", default="build/parent",
                    help="(10): the tree whose F2 forward the tree at --root's is "
                         "held against (default: build/parent)")
    args = ap.parse_args(argv)
    parts = set(args.parts.split(","))
    if args.skip_bench:
        parts.discard("bench")
    if parts - set(PARTS):
        ap.error(f"unknown parts {sorted(parts - set(PARTS))}")
    out_path = os.path.abspath(args.out)
    root = os.path.abspath(args.root)
    f2_parent = os.path.abspath(args.f2_parent)
    if not torch.cuda.is_available():
        print("f3_probe: CUDA is not available", file=sys.stderr)
        return 2
    _import(root)
    res = {"root": root, "card": cs.card_line()}
    print("card", res["card"], "torch", torch.__version__, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    _cuda.build_all()
    print(f"build {time.perf_counter() - t0:.1f} s", flush=True)
    if "chain" in parts:
        chain_costs(res)
        torch.cuda.empty_cache()
    data_dir = write_synth_dataset(os.path.join(cs.WORK_DIR, "synth4096"),
                                   num_entities=4096, num_relations=12,
                                   num_triples=8000, seed=0)
    for name, fn in (("w5m", w5m_step), ("copies", copies), ("encode", encodes),
                     ("bench", lambda r, _: r.update(cs.w5m_point())),
                     ("flagship", flagship), ("kernels", lambda r, _: kernels(r)),
                     ("f1", lambda r, _: f1(r)), ("inference", lambda r, _: inference(r)),
                     ("f2", lambda r, _: f2(r, f2_parent))):
        if name in parts:
            fn(res, data_dir)
            torch.cuda.empty_cache()
    os.makedirs(os.path.dirname(out_path), exist_ok=True)
    with open(out_path, "w") as f:
        json.dump(res, f, indent=1, default=str)
    print(f"wrote {out_path}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
