#!/usr/bin/env python3
"""On-card check of the PyTorch/CUDA port (blp_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure ends the run with a non-zero exit and no result line):

1. Require CUDA; print the card's name and power limit; keep fp32 products
   in full fp32 (no TF32).
2. Build every kernel under blp_tpu_torch/csrc/ (one nvcc per source, in
   parallel, into build/kernels/) and print the build seconds.
3. Check each kernel against its plain PyTorch version on the card: K1
   (TransE rank counts) must give identical counts; K2 (packed attention)
   must agree within rtol = atol = 2e-2.
4. Serve (the main path, part 1): a BERT-base BLP-TransE model (12 layers,
   hidden 768, 12 heads, FFN 3072, vocab 28,996, dim 128; random weights
   from seed 0) with bf16 compute and the fused attention kernel encodes a
   4,096-entity synthetic candidate table and answers JSONL requests through
   serve_loop. The same table encoded without the kernel must agree within
   1e-2 (unit-norm embeddings).
5. Evaluate (the main path, part 2): (a) two-phase filtered evaluation on the
   synthetic graph with the same encoder, held equal to a CPU run of the
   plain paths on the same table; (b) the TransE rank pass at Wikidata5M
   scale (4.8M candidates, d 128, eval batch 64, 64 filter columns, 5
   batches, then 30 to separate the per-batch cost from the set-up).
6. Time each kernel, its plain version and, where one exists, the one
   PyTorch call that computes the same function, at the main path's shapes;
   print one JSON line of kernel records (launch counts come from phases
   4-5 only, with every count set to 0 just before phase 4).

The last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import queue
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

from blp_tpu_torch import evaluation, serve
from blp_tpu_torch.data.datasets import GraphData, TextGraphData
from blp_tpu_torch.data.filtering import FilterIndex
from blp_tpu_torch.data.synth import write_synth_dataset
from blp_tpu_torch.data.tokenizers import WordPieceTokenizer
from blp_tpu_torch.models import bert, blp
from blp_tpu_torch.ops import _cuda, packed_attention, transe_rank

ROOT = os.path.dirname(os.path.abspath(__file__))
WORK_DIR = os.path.join(ROOT, "build", "chip_smoke")

# Published H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit).
HBM_BYTES_PER_S = 3.35e12
BF16_TENSOR_FLOPS = 989e12
# 67 TFLOP/s fp32 outside the tensor cores counts an FMA as two operations;
# K1's operations are plain adds (one per instruction slot), so its peak is
# half of that.
FP32_ADDS_PER_S = 67e12 / 2

K1_Q, K1_D = 128, 128            # 2 x eval batch 64, TransE dim 128
W5M_ENTITIES = 4_800_000
K2_SHAPE = (1024, 12, 128, 64)   # packed rows, heads, Sp, head dim
SEG = 32                         # max_len: segment length of a packed row


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    """Mean device milliseconds per call, from CUDA events around `reps`
    back-to-back calls after `warmup` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def wall(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def require(cond: bool, what: str) -> None:
    if not cond:
        raise SystemExit(f"FAILED: {what}")


def _kernel_group(name: str) -> str:
    low = name.lower()
    if "packed_attention" in low:
        return "K2 packed_attention"
    if "transe_rank" in low:
        return "K1 transe_rank"
    if any(s in low for s in ("gemm", "xmma", "cutlass", "nvjet", "sm90_")):
        return "GEMM (cuBLAS)"
    return "other (elementwise, reductions, copies)"


def device_profile(label: str, fn) -> dict:
    """Run `fn` once under torch.profiler; print device time by kernel group,
    the top kernels, and the device's busy share of the wall time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [(e.key, e.self_device_time_total / 1e3, e.count)
               for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.self_device_time_total > 0]
    busy = sum(ms for _, ms, _ in kernels)
    groups: dict[str, float] = {}
    for name, ms, _ in kernels:
        groups[_kernel_group(name)] = groups.get(_kernel_group(name), 0.0) + ms
    log(f"profile {label}: wall {wall_ms:.2f} ms, device busy {busy:.2f} ms "
        f"({100 * busy / wall_ms:.1f}% of wall)")
    for g, ms in sorted(groups.items(), key=lambda x: -x[1]):
        log(f"  {g}: {ms:.2f} ms ({100 * ms / max(busy, 1e-9):.1f}% of device time)")
    for name, ms, count in sorted(kernels, key=lambda x: -x[1])[:6]:
        log(f"    {ms:8.2f} ms x{count:<5d} {name[:90]}")
    return {"wall_ms": wall_ms, "busy_ms": busy,
            "groups_ms": {g: round(ms, 3) for g, ms in groups.items()}}


# -- phase 3: kernels against their plain versions --------------------------

def k1_inputs(n_rows: int, num_valid: int, seed: int):
    g = torch.Generator(device="cuda").manual_seed(seed)
    table = torch.randn((n_rows, K1_D), generator=g, device="cuda")
    table /= table.norm(dim=1, keepdim=True)
    table[num_valid:] = 0.0
    pos = torch.randint(0, num_valid, (K1_Q,), generator=g, device="cuda")
    # Exact ties: copies of some true rows elsewhere in the table.
    table[torch.arange(1000, 1016, device="cuda")] = table[pos[:16]]
    rel = 0.1 * torch.randn((K1_Q // 2, K1_D), generator=g, device="cuda")
    fixed = table[torch.randint(0, num_valid, (K1_Q // 2,), generator=g,
                                device="cuda")]
    u = torch.cat([transe_rank._offset(fixed, rel, "head"),
                   transe_rank._offset(fixed, rel, "tail")])
    r = transe_rank._seq_abs_scores(table[pos][:, None, :], u)
    return table, u, r, pos


def check_k1() -> None:
    n = 262_144
    table, u, r, pos = k1_inputs(n, n - 1000, seed=1)
    got = transe_rank.raw_counts(table, u, r, pos, n - 1000)
    want = transe_rank.raw_counts_plain(table, u, r, pos, n - 1000)
    torch.cuda.synchronize()
    require(torch.equal(got, want), "K1 counts differ from the plain version")
    log(f"K1 check: Q={K1_Q} d={K1_D} Np={n} num_valid={n - 1000}: counts "
        f"identical (sum gt={int(got[0].sum())}, geq={int(got[1].sum())})")


def k2_inputs(b: int, seed: int):
    _, nh, sp, hd = K2_SHAPE
    g = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v = (torch.randn((b, nh, sp, hd), generator=g, device="cuda")
               .to(torch.bfloat16) for _ in range(3))
    lens = torch.randint(1, SEG + 1, (b, sp // SEG), generator=g, device="cuda")
    mask = (torch.arange(SEG, device="cuda")[None, None] < lens[:, :, None])
    return q, k, v, mask.reshape(b, sp).float()


def check_k2() -> None:
    q, k, v, mask = k2_inputs(64, seed=2)
    scale = 1.0 / math.sqrt(q.shape[-1])
    got = packed_attention.block_diag_attention(q, k, v, mask, seg=SEG, scale=scale)
    want = packed_attention.block_diag_attention_plain(q, k, v, mask, seg=SEG,
                                                       scale=scale)
    err = (got.float() - want.float()).abs().max().item()
    require(torch.allclose(got.float(), want.float(), rtol=2e-2, atol=2e-2),
            f"K2 differs from the plain version (max abs err {err})")
    log(f"K2 check: B=64 nh=12 Sp=128 hd=64 seg={SEG}: max abs err {err:.3g} "
        f"(tolerance 2e-2)")


# -- phase 4: serve ----------------------------------------------------------

def make_model(num_relations: int) -> tuple[blp.ModelConfig, dict]:
    enc = bert.BertConfig(compute_dtype=torch.bfloat16, fused_attention=True)
    cfg = blp.ModelConfig(model="blp", rel_model="transe", dim=128,
                          num_relations=num_relations, encoder=enc)
    params = blp.init_params(cfg, torch.Generator().manual_seed(0),
                             device="cuda")
    return cfg, params


def serve_phase(data_dir: str, cfg, params) -> dict:
    tok = WordPieceTokenizer(os.path.join(data_dir, "vocab.txt"))
    lines = open(os.path.join(data_dir, "entity2text.txt"),
                 encoding="utf-8").read().splitlines()
    names = [ln.split("\t")[0] for ln in lines]
    texts = [ln.split("\t")[1] for ln in lines]
    n = len(texts)
    srv = serve.LinkPredictor(params=params, cfg=cfg, tokenizer=tok,
                              max_len=SEG, device="cuda")
    _, cold_s = wall(lambda: srv.set_candidates_from_texts(
        np.arange(n), texts, batch_size=n))
    _, warm_s = wall(lambda: srv.set_candidates_from_texts(
        np.arange(n), texts, batch_size=n))
    ids, mask = tok.batch_encode(texts, SEG)
    enc_times = [wall(lambda: srv._encode(srv.params, ids, mask))[1]
                 for _ in range(3)]
    log(f"serve encode: {n} entities, cold {cold_s:.3f} s, warm "
        f"{warm_s:.4f} s incl. tokenizing = {n / warm_s:,.0f} entities/s; "
        f"one pre-tokenized {n}-entity batch {min(enc_times) * 1e3:.2f} ms "
        f"(best of 3) = {n / min(enc_times):,.0f} entities/s")
    encode_prof = device_profile(f"encode of {n} entities",
                                 lambda: srv._encode(srv.params, ids, mask))

    ent_ids = {name: i for i, name in enumerate(names)}
    rel_ids = {f"rel_{i}": i for i in range(cfg.num_relations)}
    reqs = [
        {"id": "t1", "op": "tails", "rel": "rel_0", "head": names[3], "k": 10},
        {"id": "t2", "op": "tails", "rel": 1, "head": names[70], "k": 10},
        {"id": "t3", "op": "tails", "rel": "rel_2", "head_text": texts[11], "k": 10},
        {"id": "t4", "op": "tails", "rel": 3, "head_text": "protein binds receptor", "k": 10},
        {"id": "h1", "op": "heads", "rel": "rel_1", "tail": names[5], "k": 10},
        {"id": "h2", "op": "heads", "rel": 0, "tail": names[4000], "k": 10},
        {"id": "h3", "op": "heads", "rel": "rel_3", "tail_text": texts[9], "k": 10},
        {"id": "h4", "op": "heads", "rel": 2, "tail_text": "virus causes disease", "k": 10},
        {"id": "bad", "op": "tails", "rel": 999, "head": names[1]},
    ]
    q: queue.Queue = queue.Queue()
    for r in reqs:
        q.put(json.dumps(r))
    q.put(None)
    out: list[str] = []
    stats, loop_s = wall(lambda: serve.serve_loop(
        srv, q, out.append, ent_ids=ent_ids, rel_ids=rel_ids, linger_s=0.01))
    resp = {json.loads(o)["id"]: json.loads(o) for o in out}
    require(len(resp) == len(reqs), f"{len(resp)} responses to {len(reqs)} requests")
    errors = [rid for rid, r in resp.items() if "error" in r]
    require(errors == ["bad"], f"error lines {errors}, expected only 'bad'")
    for rid, r in resp.items():
        if rid == "bad":
            continue
        s = np.asarray(r["scores"])
        require(len(r["entities"]) == 10 and len(s) == 10, f"{rid}: not 10 answers")
        require(np.isfinite(s).all() and (np.diff(s) <= 0).all(),
                f"{rid}: scores not finite and descending")
    log(f"serve_loop: {stats}; {len(reqs)} requests in {loop_s * 1e3:.1f} ms "
        f"({loop_s * 1e3 / stats['batches']:.1f} ms per batch); error line: "
        f"{resp['bad']['error']}")

    # Same table without the fused kernel (the einsum attention path).
    cfg_plain = dataclasses.replace(
        cfg, encoder=dataclasses.replace(cfg.encoder, fused_attention=False))
    ref = blp.encode(blp.encode_view(params, cfg_plain), cfg_plain, ids, mask,
                     device="cuda")
    diff = (srv._table[:n] - ref).abs().max().item()
    require(diff <= 1e-2, f"fused vs einsum attention encode differ by {diff}")
    log(f"encode with K2 vs without: max abs diff {diff:.3g} (limit 1e-2)")
    return {"encode_entities_per_s": n / warm_s,
            "encode_batch_ms": min(enc_times) * 1e3,
            "requests": len(reqs), "serve_loop_ms": loop_s * 1e3,
            "serve_batches": stats["batches"], "fused_vs_einsum": diff,
            "encode_profile": encode_prof}


# -- phase 5: evaluation -------------------------------------------------------

def eval_phase(data_dir: str, cfg, params) -> dict:
    tok = WordPieceTokenizer(os.path.join(data_dir, "vocab.txt"))
    train = TextGraphData.load(os.path.join(data_dir, "ind-train.tsv"),
                               tokenizer=tok, max_len=SEG, write_maps=True)
    test = GraphData.load(os.path.join(data_dir, "ind-test.tsv"))
    dev = GraphData.load(os.path.join(data_dir, "ind-dev.tsv"))
    all_triples = np.concatenate([train.triples, dev.triples, test.triples])
    entities = np.arange(len(train.ent_ids))
    kw = dict(filter_index=FilterIndex(all_triples),
              new_entities=np.setdiff1d(entities, train.entities),
              rel_categories=train.rel_categories, batch_size=64)
    res, eval_s = wall(lambda: evaluation.eval_link_prediction(
        params, cfg, test.triples, train, entities, emb_batch_size=4096,
        return_embeddings=True, device="cuda", **kw))
    log(f"eval (synth, {len(test.triples)} test triples, {len(entities)} "
        f"candidates): {eval_s:.2f} s; MRR {res.mrr:.4f} filtered "
        f"{res.mrr_filt:.4f} hits@1/3/10 filtered "
        f"{[round(res.hits_filt[k], 4) for k in (1, 3, 10)]}")
    # The same table ranked by the plain paths on the CPU must give the same
    # counts, hence the same metrics.
    ref = evaluation.eval_link_prediction(
        {"rel_emb": params["rel_emb"].cpu()}, cfg, test.triples, train,
        entities, ent_emb=res.ent_emb, device="cpu", **kw)
    require(ref.scalars("x") == res.scalars("x"),
            "card and CPU evaluations of the same table differ")
    log("eval: card metrics equal the CPU plain-path metrics on the same table")

    # Wikidata5M scale: the K1 rank pass over 4.8M candidates.
    g = torch.Generator(device="cuda").manual_seed(5)
    n = W5M_ENTITIES
    table = torch.randn((n, K1_D), generator=g, device="cuda")
    table /= table.norm(dim=1, keepdim=True)
    rng = np.random.default_rng(5)
    # A 5-batch pass, and a 30-batch one: the difference is the per-batch
    # cost without the one-time set-up (the 4.8M-entry id map, the padding).
    b, n_batches, n_long, num_rels = 64, 5, 30, 16
    trip = np.stack([rng.integers(0, n, b * n_long),
                     rng.integers(0, n, b * n_long),
                     rng.integers(0, num_rels, b * n_long)], axis=1)
    extra = []
    for h, t, r in trip:  # 40 known answers each way -> 64 filter columns
        extra.append(np.stack([np.full(40, h), rng.integers(0, n, 40),
                               np.full(40, r)], axis=1))
        extra.append(np.stack([rng.integers(0, n, 40), np.full(40, t),
                               np.full(40, r)], axis=1))
    fidx = FilterIndex(np.concatenate([trip] + extra))
    w_params = {"rel_emb": 0.1 * torch.randn((num_rels, K1_D), generator=g,
                                             device="cuda")}
    w_cfg = blp.ModelConfig(model="transductive", rel_model="transe",
                            dim=K1_D, num_relations=num_rels, num_entities=n)
    def w5m_eval(batches):
        return evaluation.eval_link_prediction(
            w_params, w_cfg, trip, None, np.arange(n), batch_size=b,
            filter_index=fidx, ent_emb=table, max_num_batches=batches,
            device="cuda")

    w_res, w_s = wall(lambda: w5m_eval(n_batches))
    _, w_long_s = wall(lambda: w5m_eval(n_long))
    marginal_ms = (w_long_s - w_s) * 1e3 / (n_long - n_batches)
    log(f"eval at Wikidata5M scale ({n:,} candidates, {n_batches} batches of "
        f"{b}, 64 filter columns): {w_s:.3f} s end to end = "
        f"{w_s * 1e3 / n_batches:.1f} ms per bidirectional batch (set-up "
        f"included); {n_long} batches {w_long_s:.3f} s, so "
        f"{marginal_ms:.2f} ms per further batch; MRR {w_res.mrr:.6f}")
    w5m_prof = device_profile(
        f"Wikidata5M-scale rank pass ({n_long} batches)",
        lambda: w5m_eval(n_long))
    del table
    torch.cuda.empty_cache()
    return {"synth_mrr": res.mrr, "synth_mrr_filt": res.mrr_filt,
            "synth_hits_filt": res.hits_filt, "synth_eval_s": eval_s,
            "w5m_ms_per_batch": w_s * 1e3 / n_batches,
            "w5m_marginal_ms_per_batch": marginal_ms, "w5m_profile": w5m_prof}


# -- phase 6: timings at the main path's shapes ----------------------------------

def time_k1(launches: int) -> dict:
    n = W5M_ENTITIES
    table, u, r, pos = k1_inputs(n, n, seed=3)
    got = transe_rank.raw_counts(table, u, r, pos, n)
    want = transe_rank.raw_counts_plain(table, u, r, pos, n)
    err = (got - want).abs().max().item()
    require(err == 0, f"K1 counts differ at the Wikidata5M shape by {err}")
    ms = cuda_ms(lambda: transe_rank.raw_counts(table, u, r, pos, n), reps=10)
    plain_ms = cuda_ms(lambda: transe_rank.raw_counts_plain(table, u, r, pos, n),
                       reps=2)
    ops = 2.0 * K1_Q * n * K1_D
    nbytes = 4.0 * (n * K1_D + K1_Q * K1_D + 2 * K1_Q + 2 * K1_Q)
    t_ops, t_bytes = ops / FP32_ADDS_PER_S * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    del table
    torch.cuda.empty_cache()
    return {"name": "transe_rank (K1)", "route": "cuda",
            "source": "blp_tpu_torch/csrc/transe_rank.cu",
            "replaces": "blp_tpu/ops/pallas_ranking.py:57",
            "launches": launches, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": None,
            "shape": f"Q={K1_Q} Np={n} d={K1_D} fp32"}


def time_k2(launches: int) -> dict:
    b, nh, sp, hd = K2_SHAPE
    q, k, v, mask = k2_inputs(b, seed=4)
    scale = 1.0 / math.sqrt(hd)
    got = packed_attention.block_diag_attention(q, k, v, mask, seg=SEG, scale=scale)
    want = packed_attention.block_diag_attention_plain(q, k, v, mask, seg=SEG,
                                                       scale=scale)
    err = (got.float() - want.float()).abs().max().item()
    require(torch.allclose(got.float(), want.float(), rtol=2e-2, atol=2e-2),
            f"K2 error {err} at the main-path shape")
    del got, want
    ms = cuda_ms(lambda: packed_attention.block_diag_attention(
        q, k, v, mask, seg=SEG, scale=scale), reps=20, warmup=3)
    plain_ms = cuda_ms(lambda: packed_attention.block_diag_attention_plain(
        q, k, v, mask, seg=SEG, scale=scale), reps=3)
    bias = packed_attention.block_bias(mask, SEG).to(torch.bfloat16)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    library_ms = cuda_ms(lambda: sdpa(q, k, v, attn_mask=bias, scale=scale),
                         reps=20, warmup=3)
    nbytes = 2.0 * 4 * b * nh * sp * hd + 4.0 * b * sp
    flops = 2.0 * 2 * b * nh * sp * sp * hd
    t_ops, t_bytes = flops / BF16_TENSOR_FLOPS * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    return {"name": "packed_attention (K2)", "route": "cuda",
            "source": "blp_tpu_torch/csrc/packed_attention.cu",
            "replaces": "blp_tpu/ops/pallas_attention.py:56",
            "launches": launches, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": library_ms,
            "shape": f"B={b} nh={nh} Sp={sp} hd={hd} seg={SEG} bf16"}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"devices {torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    built = _cuda.build_all()
    log(f"build: {time.perf_counter() - t0:.2f} s wall for "
        f"{ {k: round(v, 2) for k, v in built.items()} } (parallel nvcc)")
    for name in _cuda.SOURCES:
        log_path = _cuda.BUILD_DIR / f"{name}.log"
        if log_path.exists():
            for line in log_path.read_text().splitlines():
                if "registers" in line or "spill" in line:
                    log(f"  {name}: {line.strip()}")

    check_k1()
    check_k2()

    shutil.rmtree(WORK_DIR, ignore_errors=True)
    data_dir = write_synth_dataset(os.path.join(WORK_DIR, "synth4096"),
                                   num_entities=4096, num_relations=12,
                                   num_triples=8000, seed=0)
    cfg, params = make_model(num_relations=12)

    transe_rank.launches = 0
    packed_attention.launches = 0
    serve_stats = serve_phase(data_dir, cfg, params)
    eval_stats = eval_phase(data_dir, cfg, params)
    launches = {"K1": transe_rank.launches, "K2": packed_attention.launches}
    log(f"main-path launches: {launches}")
    require(launches["K1"] > 0 and launches["K2"] > 0,
            "a kernel of the main path was never launched")
    del params
    torch.cuda.empty_cache()

    kernels = [time_k1(launches["K1"]), time_k2(launches["K2"])]
    for kr in kernels:
        log(f"{kr['name']}: {kr['ms']:.3f} ms (plain {kr['plain_ms']:.3f} ms, "
            f"library {kr['library_ms']}, bound {kr['bound_ms']:.3f} ms by "
            f"{kr['bound_by']}) at {kr['shape']}")
    log("summary: " + json.dumps({**serve_stats, **eval_stats}))
    shutil.rmtree(WORK_DIR, ignore_errors=True)
    print(card)   # name, power limit: nvidia-smi's own line
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
