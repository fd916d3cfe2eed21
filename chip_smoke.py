#!/usr/bin/env python3
"""On-card check of the PyTorch/CUDA port (blp_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure ends the run with a non-zero exit and no result line):

1. Require CUDA; print the card's name and power limit; keep fp32 products
   in full fp32 (no TF32).
2. Build every kernel under blp_tpu_torch/csrc/ (one nvcc per source, in
   parallel, into build/kernels/) and print the build seconds; then build
   the native data packer (g++, into build/native/) and print its seconds.
3. Check each kernel against its plain PyTorch version on the card: K1
   (TransE rank counts, at d 128, 300 and 768 on its "tma" variant, and at
   d 128 on its "scalar" variant through a view 4 bytes off) must give
   identical counts;
   K2 (packed attention, with about 1 row in 8 ending in empty segments, at
   segment lengths 32 and 64) must agree within rtol = atol = 2e-2, and the
   max error and the share of outputs more than one bf16 ulp away are
   printed for each; K3 (the SDDMM scorer of training, forward and backward kernels)
   for all four scorers at B = 64 and 1,024 (K 64, d 128, fp32) and at
   B = 64 with d 300 and 768, on
   negatives from the port's sampler and on an adversarial set (a hot row
   on both sides, own slots, and K = 0): scores within rtol = atol = 1e-5,
   margin-loss gradients within rtol 1e-5, atol 1e-6 of plain autograd and
   identical across two backward calls (and whether they equal the plain
   backward run on the CPU, bit for bit, is printed). F2's backward (ds, dr,
   dscale and dbias) must be one device launch a call, as torch.profiler
   records it at the W5M train step's 131,072 x 768.
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
6. Train (the main path, part 3), with every count set to 0 again just
   before it: (b) the flagship BERT-base BLP-TransE train step (bf16,
   dropout 0.1, sddmm_pallas=True, B 64, L 32, 64 negatives, Adam with
   warmup): 3 warm-up and 20 timed steps with finite losses, a profile of
   one step, and the same step with sddmm_pallas=False from the same
   parameters and seeds (loss within rtol 1e-4, `proj` and `rel_emb`
   gradients within rtol 1e-3, atol 1e-6); (c) the Wikidata5M operating
   point (B 1,024, L 64, remat=8): 3 steps, ms per step and peak memory;
   (d) `python -m blp_tpu_torch.train link_prediction` in-process, one
   epoch on the synthetic graph with the BERT-base encoder in bf16, then
   `resume=auto` to a second epoch. ((a), the K3 check, is in phase 3.)
8. The word-embedding models (the main path, part 4; it runs after phase 6,
   before the timings of phase 7), with every count set to 0 again just
   before it; fp32, TransE, dim 128, regularizer 1e-2,
   sddmm_pallas=True, random weights from seed 0, the widths of
   scripts/*-{bow,dkrl}-*.sh: (a) bert-dkrl at the FB15k-237 keys (emb 768,
   a 28,996-row word table, B 64, L 32, K 64, lr 1e-4): 3 warm-up and 20
   timed steps, a profile, and the same step without K3 (loss within rtol
   1e-4); (b) glove-dkrl at the Wikidata5M keys (B 1,024, L 64, emb 300, a
   400,000-row word table): 3 steps, ms per step, peak memory, a profile;
   (c) glove-bow (entity width 300) and bert-bow (768): one train step
   each, then the two-phase filtered evaluation of the synthetic graph,
   its first 8 batches held equal to the CPU plain paths on the same table;
   (d) in-process, `link_prediction` with model=bert-dkrl for one epoch,
   `node_classification` on its export, and the retrieval reranker with
   that checkpoint on synthetic files the size of DBpedia-Entity v2 (467
   queries, 100 BM25F candidates each, 5 folds), each timed.
9. The multi-device paths (after phase 8, before the timings of phase 7),
   with every count set to 0 again just before it: (a) the flagship step
   under remat False, True, "dots" and "names": gradients bit-equal to
   remat=False (dropout on), ms per step and peak memory; then 2 ranks on the
   one card (gloo; NCCL refuses two ranks on one device), spawned together:
   (b) the TransE rank pass at Wikidata5M scale (4.8M x 128 fp32, 30 batches
   of 64, 64 filter columns) with each rank counting its block through K1:
   the summed counts equal a one-process pass bit for bit and every K1
   launch takes "tma"; and the sharded evaluation of the synthetic graph
   with K2 in each rank's phase-1 encode: its table within 1e-2 of the
   one-process table, its metrics equal to one process on that table;
   (c) one fp32 BERT-base train step (B 64, L 32, K3, dropout on) each under
   DP 2 x 1, TP 1 x 2 and PP 1 x 2 with 4 microbatches: loss within rtol
   1e-5 and every gradient within rtol 2e-5, atol 2e-6 of the one-process
   step's (the parameters after Adam's step are reported beside them: a
   gradient near eps turns rounding into lr-sized moves); (d) `python -m torch.distributed.run --nproc-per-node 2 -m
   blp_tpu_torch.train link_prediction with num_data_shards=2` (tiny
   encoder) for one epoch, then `resume=auto` on one process for the
   second. The launches of (a) and of the ranks count; the one-process
   passes they are held to do not. Ranks sharing one card time the paths,
   not their scaling.
10. The modules that complete the port (after phase 9, before the timings
   of phase 7), with every count set to 0 again just before it. The
   link_prediction command runs in-process with K2 and K3 switched on in
   the model config it builds (its own defaults, as the TPU package's,
   leave both off). (a) The native packer built (phase 2's seconds); the
   4,096-entity graph's triple files and token matrix equal the Python
   path's; both load a 1M-triple random graph (host times of this
   machine). (b) A reference-shaped BERT-base BLP-TransE state dict (random
   from seed 0, `module.` prefix) goes through `python -m
   blp_tpu_torch.tools.convert_reference_checkpoint`, then `link_prediction
   max_epochs=0 checkpoint=` (bf16): its test MRR, raw and filtered, equals
   an in-process evaluation of the converted parameters, and it launches
   K1 and K2. (c) Phase 1 of the 4,096 entities (BERT-base bf16, K2, chunks
   of 1,024) from evaluation.build_entity_table, whose prefetch thread
   gathers and copies the chunks, and from an in-line loop over the same
   chunks: tables bit-equal; entities/s of both; the device's busy share
   from profiling.summarize_trace_stats. (d) A one-epoch run (B 64, L 32,
   K3) on a 1,024-entity synthetic graph; marker-less stacked and unstacked copies of its state file load to
   its parameters and Adam moments bit for bit and resume at epoch 2,
   whose steps launch K3. (e) profiling.StepTimer over 5 flagship steps; 3
   steps traced, whose summarized device time is within 2% of
   device_profile's for the same 3 steps; device_memory_stats' peak equals
   max_memory_allocated.
11. The Wikidata5M mode (after phase 10, before the timings of phase 7),
   with every count set to 0 again just before it, K2 and K3 switched on as
   in phase 10. (a) `link_prediction` in-process with every key of
   scripts/blp-transe-wikidata5m.sh (BERT-base bf16, remat=8, max_len 64,
   B 1,024, K 64, lr 5e-5 with warmup, emb_batch_size 12,288,
   large_dataset=True) for one epoch on a 20,000-entity synthetic graph
   with 3% of its entities held out (22 steps; valid and test splits of
   several hundred triples): seconds a step and each evaluation's seconds;
   K3 launched once a step forward and backward, K2 only at seg 64, 12 per
   encode, K1 once a batch of every evaluation. (b) The -pretrained keys
   (`max_epochs=0 checkpoint=<(a)'s model file> use_cached_text=True`):
   valid and test MRR, raw and filtered, equal to (a)'s final evaluation,
   the text cache read and not rewritten. (c) `python -m
   blp_tpu_torch.tools.w5m_e2e_eval` at 262,144 candidates (BERT-base bf16,
   max_len 64, emb-batch 12,288: K2 on 6,144-row chunks at seg 64): encode
   and rank seconds, entities/s, mrr_filt; `w5m_scale_check --n 1000000`:
   the streamed rank pass's seconds and peak memory. (d) `umls_smoke`: its
   wall seconds beside the reference's "< 60 s on GPU", and test MRR.
12. The measurement entry points (after phase 11, before the timings of
   phase 7), with every count set to 0 again just before it; none of them
   launches K2 or K3 (their TPU counterparts leave both off). (a)
   `blp_tpu_torch.tools.rank_bench` at its default (4.8M x 128, B 64, 64
   filter columns): the plain stream's and K1's ms a both-direction call,
   the count entries more than 1 apart, none beyond the fp32 rounding band
   of its pivot, K1 launched 6 times; (b) `serving_bench` at
   1M candidates, batches 1, 8 and 64: p50, p95 and queries/s, and the
   answers of a server built as the tool builds it: ids in range, scores
   finite and sorted; (c) `measure_reference_baseline` (the reference's
   BERT-base step rebuilt from torch.nn, fp32, B 16) into the work
   directory; (d) the flagship bench step (BERT-base bf16, B 128, L 32, K
   64) through `bench.measure` with 2 windows of 20 steps, `vs_baseline`
   against (c)'s file, which must be positive; (e) `family_bench` for every
   family at 2 steps a window, blp-w5m included, each rate positive and
   finite; (f) `python
   -m torch.distributed.run --nproc-per-node 2 -m
   blp_tpu_torch.tools.scaling_bench --device cuda:0`: the train and
   eval_rank rows at (1, 1) and (2, 1) (2 gloo ranks on the card: overhead,
   not scaling).
13. The layer's fused chains, F1 (bias + activation) and F2 (residual +
   LayerNorm), after phase 12, before the timings of phase 7. (a) Each
   against its plain version, forward and backward, at the main path's
   variants and shapes (F1: none at 768 wide, erf and poly at 3072, over
   the W5M train step's 131,072 rows and, forward, the encode chunk's
   786,432; f32 h, f32 out and fp32 at 16,384 rows. F2: with r in bf16,
   without r from f32 (the embedding LayerNorm), fp32): bf16 outputs and
   dh within one bf16 ulp (F2's within one ulp plus 1e-5 of the largest,
   the f32 order of its row sums), f32 outputs within rtol 1e-5, db,
   dscale and dbias within rtol 1e-4 (atol 1e-4 of the largest), every
   gradient identical across two backward calls; the plain references run
   in row blocks of 16,384. F1 head-major (q, k and v: y (B, 12, S, 64)
   from (B, S, 768)) at the W5M train step's 1,024 x 128 with q's and k's
   cotangents (k's held (B, 12, 64, S), as q k^T's backward leaves it) and,
   forward, at the encode chunk's 6,144 x 128: y and dh bit-equal, db as
   above. Then, with every count set to 0 again: (b) the
   TPU bench's W5M point (B 1,024, L 64, K 64, remat=4, fast_train, 8-bit
   masks) through `bench.measure` with 2 windows of 10 steps: ms a step,
   triples/s, peak memory below 80 GB; (c) phase 6 (c)'s remat=8 peak
   beside its 30.85 GiB before; (d) one phase-1 chunk of 12,288 entities
   at L 64 (BERT-base bf16, K2): ms, entities/s, peak beside 72.01 GiB.
14. The attention softmax chain, F3 (scale, mask bias, softmax, dropout),
   after phase 13, before the timings of phase 7. (a) F3 against its plain
   version and the plain version's autograd VJP: the training variant with
   8- and 32-bit masks at the W5M train step's 1,024 packed rows (12 heads,
   Sp 128, two 64-token segments), the inference variant (bf16 logits) at
   the W5M encode chunk's 6,144 rows and at L 32's 1,024, and at 64 rows
   bf16 -> f32, fp32, no dropout and an unpacked bias; each with row 0's
   keys all masked: bf16 within one bf16 ulp plus 1e-5 of the largest (y
   with dropout within two: its second rounding), f32 within rtol 1e-5
   (atol 1e-5 of the largest), dl identical across two backward calls. Then, each with every count set to 0 just before it:
   (b) phase 6 (c)'s W5M step at remat=8 again (its launches: F3 and its
   backward must occur); (c) phase 4's 4,096 entities at L 32 encoded with
   `fused_attention=False`, the CLI's layer (F3's inference variant, no
   K2), best of 5, held within 1e-2 of the K2 table, with both rates.
15. The dropout masks inside the kernels, after phase 14, before the
   timings of phase 7. (a) At the W5M train step's shapes and each
   dropout_bits (8, 16, 32), on blocks of larger sites (rows and heads
   offset): F3's masks, forward (y != 0 where kept, uniform probabilities)
   and backward (the sign of dl under a unit cotangent), equal to the plain
   generator's (ops/dropout_rng.py); F2's s = x + drop(r) and dr = drop(ds)
   bit-equal to the plain chain; the site kernel's drop(x) and drop(g)
   bit-equal to the plain version. Then, with every count set to 0: (b)
   phase 6 (c)'s W5M step (remat=8, 32-bit masks) and the bench --w5m
   point's step (remat=4, fast_train, 8-bit masks), each after warm-up,
   profiled by kernel name with shapes recorded: no torch draw and no
   `where` on a dropout site's shape, and no more RNG kernels than the
   sampler's two draws; F2, F3, their backwards and the site kernel
   launched; the copy kernels by the launching op and its input shapes.
7. Time each kernel, its plain version and, where one exists, the one
   PyTorch call that computes the same function, at the main path's shapes
   (K3's backward: the kernel with its index bookkeeping against the plain
   formulation's VJP, the parent design's backward), and K1 and K3 again at
   the word models' widths (d 300 and 768; K1 at the Wikidata5M candidate
   count); print one JSON line of kernel records. A record's launches are
   the sum of the counts read after phases 4-5 (inference), after phase 6
   (train) and after phase 8 (word models), each path driven with every
   count (K3's forward and backward each have one) set to 0 just before it,
   plus phase 9's to 15's.
   K1's record also counts its launches by variant and width (every
   main-path launch must take the "tma" variant, at d 128, 300 and 768),
   reads the SM clock right after its timing with the kernel running, and
   times the retained "scalar" variant beside it at each width. K2's record
   counts its launches by segment length (both 32 and 64 must occur) and
   times it again at the Wikidata5M phase-1 chunk (6,144 rows, seg 64)
   under `at_seg64`. F1 and F2 (no Pallas counterpart: XLA fusions in the
   TPU package) have a record each for forward and backward, with their
   launches by variant (F1's by layout too), at the W5M train step's
   shapes (F1 poly at 131,072 x 3072, and none at 768 under `at_w768_none`,
   head-major under `at_w768_none_heads`, its backward from q's and k's
   head-major cotangents under `at_heads_q`, `at_heads_k`; F2 at 131,072 x
   768) and,
   forward, at the encode chunk's (`at_encode`), F2 also with 8- and
   32-bit masks (`at_drop8`, `at_drop32`; its backward with 8-bit masks, dr
   beside ds, and `at_drop32`, `at_no_dropout`) and on the embedding
   LayerNorm's f32 x alone (`at_emb`); F3 at the W5M train
   shape with 8-bit masks (`at_drop32`: 32-bit), each mask evaluated in
   the kernel, and, forward, its inference variant at the
   encode chunk's (`at_encode`) and L 32's rows (`at_l32`), its
   `library_ms` torch.softmax (or aten._softmax_backward_data) on the f32
   logits; the site kernel (the embedding output's dropout) at the W5M
   step's 131,072 x 768 with 32-bit masks (`at_drop8`: 8-bit), its
   `library_ms` F.dropout (torch's own mask); a bound's operations count
   the generator's (~100 integer operations a Philox call, shared by the
   call's 4, 8 or 16 masks). F1's and F2's `library_ms` is
   F.gelu or F.layer_norm (or their backward) on the already-added input,
   which covers part of the function (`library_covers`); for F1 at "none"
   h + b in bf16, all of it; for F1's backward at "none" (db alone: dh is
   g) g's f32 column sum, all of it, and from a head-major cotangent its
   permute copy alone. The word tables' gather backward (`index_put_segsum`,
   no Pallas counterpart: XLA's scatter-add) at the W5M step's ids as the
   benchmark's w5m-train traffic draws them, over glove-dkrl's 400,001 x 300
   table and (`at_w768`) blp-bert-base's 28,996 x 768: bit-equal to its plain
   version and between calls, within the f32 summation bound of a float64
   sum; `ms` the kernel alone, `with_sort_ms` the whole call, `library_ms`
   torch's index backward and `embedding_backward_ms`
   aten.embedding_dense_backward on the same ids.

The last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import functools
import io
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

import word_grad_probe
from blp_tpu_torch import (evaluation, native, profiling, retrieval, serve,
                           train, training)
from blp_tpu_torch import checkpoint as ckpt
from blp_tpu_torch.checkpoint import tree_leaves as _leaves
from blp_tpu_torch.config import ExperimentConfig, parse_overrides
from blp_tpu_torch.data import prefetch, sampling
from blp_tpu_torch.data.datasets import GraphData, TextGraphData
from blp_tpu_torch.data.filtering import FilterIndex
from blp_tpu_torch.data.loader import epoch_batches, text_train_batch
from blp_tpu_torch.data.synth import write_synth_dataset, write_tiny_glove
from blp_tpu_torch.data.tokenizers import GloVeTokenizer, WordPieceTokenizer
from blp_tpu_torch.models import bert, blp
from blp_tpu_torch.ops import (_cuda, attn_softmax, dropout_rng, fused_layer,
                               packed_attention, row_gather, sddmm,
                               transe_rank)

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
# The Wikidata5M keys (max_len 64, emb_batch_size 12,288): a phase-1 chunk
# is 6,144 packed rows of two 64-token segments.
W5M_SEG, W5M_K2_ROWS = 64, 6144
K2_SEGS = (SEG, W5M_SEG)
K3_BATCHES = (64, 1024)          # flagship and Wikidata5M train batch sizes
K3_K, K3_D = 64, 128             # negatives per edge, entity width
# Entity widths of the word models' TransE path: the BOW models embed at the
# word width (GloVe 300, BERT 768); the DKRL models at dim 128.
WORD_DIMS = (300, 768)
BERT_VOCAB = 28_996              # bert-base-cased's word table
GLOVE_ROWS = 400_000             # GloVe 6B's vocabulary
# DBpedia-Entity v2: its queries, the BM25F candidates kept per query, folds.
IR_QUERIES, IR_CANDIDATES, IR_FOLDS = 467, 100, 5
BOW_EVAL_BATCHES = 8             # batches of (c) held against the CPU
# K3's TransE terms per element: the add, the subtract (|.| folds into an
# operand) and the accumulate, each one non-FMA fp32 instruction.
K3_TRANSE_OPS = 3
# Its backward per task element: (h + r) - t (2), sign times -g (1), and the
# three accumulates into the head, tail and relation gradients (3).
K3_TRANSE_BWD_OPS = 6


#: Each kernel's launch counter: (module, attribute), a plain int.
COUNTERS = {"K1": (transe_rank, "launches"),
            "K2": (packed_attention, "launches"),
            "K3": (sddmm, "launches"),
            "K3 backward": (sddmm, "backward_launches"),
            "F1": (fused_layer, "bias_act_launches"),
            "F1 backward": (fused_layer, "bias_act_backward_launches"),
            "F2": (fused_layer, "add_layer_norm_launches"),
            "F2 backward": (fused_layer, "add_layer_norm_backward_launches"),
            "F3": (attn_softmax, "launches"),
            "F3 backward": (attn_softmax, "backward_launches"),
            "site dropout": (fused_layer, "site_dropout_launches"),
            "word-table backward": (row_gather, "launches")}
#: Launch counts split by shape or variant (Counters).
BY_KEYS = ("K1 by variant", "K2 by seg", "F by variant")


def reset_counts() -> None:
    for mod, attr in COUNTERS.values():
        setattr(mod, attr, 0)
    transe_rank.launches_by_variant.clear()
    packed_attention.launches_by_seg.clear()
    fused_layer.launches_by_variant.clear()


def read_counts() -> dict:
    counts = {name: getattr(mod, attr) for name, (mod, attr) in COUNTERS.items()}
    counts["K1 by variant"] = collections.Counter(transe_rank.launches_by_variant)
    counts["K2 by seg"] = collections.Counter(packed_attention.launches_by_seg)
    counts["F by variant"] = collections.Counter(fused_layer.launches_by_variant)
    return counts


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


def cuda_ms_in_turns(a, b, reps: int = 20, warmup: int = 3) -> tuple[float, float]:
    """`cuda_ms` of a and of b read in turns (a, b, b, a), the better of each
    side's two reads: neither side always runs first, right after another
    case's heavy work."""
    a1, b1, b2, a2 = (cuda_ms(f, reps, warmup) for f in (a, b, b, a))
    return min(a1, a2), min(b1, b2)


def device_ms(fn, reps: int, warmup: int = 3) -> tuple[float, float, dict]:
    """Mean device milliseconds per call: the self time of every kernel the
    calls launched, summed by torch.profiler. For calls whose kernels take
    microseconds, where CUDA events around back-to-back calls time the
    host's launch path instead. Also returns the device launches per call
    and the milliseconds per call by kernel name."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    total_us = sum(e.self_device_time_total for e in events)
    by_name = {e.key: e.self_device_time_total / 1e3 / reps for e in events}
    return (total_us / 1e3 / reps, sum(e.count for e in events) / reps,
            by_name)


def wall(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def require(cond: bool, what: str) -> None:
    if not cond:
        raise SystemExit(f"FAILED: {what}")


def device_profile(label: str, fn) -> dict:
    """Run `fn` once under torch.profiler; print device time by kernel group,
    the top kernels, the device's busy share of the wall time, and the host
    calls that wait for the device (stream and device synchronisations, and
    the synchronous copies behind them)."""
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
    waits = {e.key: e.count for e in prof.key_averages()
             if e.key in ("cudaStreamSynchronize", "cudaDeviceSynchronize",
                          "cudaMemcpyAsync")}
    groups = profiling.device_time_by_group((name, ms) for name, ms, _ in kernels)
    log(f"profile {label}: wall {wall_ms:.2f} ms, device busy {busy:.2f} ms "
        f"({100 * busy / wall_ms:.1f}% of wall)")
    for g, ms in groups.items():
        log(f"  {g}: {ms:.2f} ms ({100 * ms / max(busy, 1e-9):.1f}% of device time)")
    for name, ms, count in sorted(kernels, key=lambda x: -x[1])[:6]:
        log(f"    {ms:8.2f} ms x{count:<5d} {name[:90]}")
    log(f"  host calls that wait for the device: {waits}")
    return {"wall_ms": wall_ms, "busy_ms": busy, "host_waits": waits,
            "groups_ms": {g: round(ms, 3) for g, ms in groups.items()}}


# -- phase 3: kernels against their plain versions --------------------------

def k1_inputs(n_rows: int, num_valid: int, seed: int, d: int = K1_D):
    g = torch.Generator(device="cuda").manual_seed(seed)
    table = torch.randn((n_rows, d), generator=g, device="cuda")
    table /= table.norm(dim=1, keepdim=True)
    table[num_valid:] = 0.0
    pos = torch.randint(0, num_valid, (K1_Q,), generator=g, device="cuda")
    # Exact ties: copies of some true rows elsewhere in the table.
    table[torch.arange(1000, 1016, device="cuda")] = table[pos[:16]]
    rel = 0.1 * torch.randn((K1_Q // 2, d), generator=g, device="cuda")
    fixed = table[torch.randint(0, num_valid, (K1_Q // 2,), generator=g,
                                device="cuda")]
    u = torch.cat([transe_rank._offset(fixed, rel, "head"),
                   transe_rank._offset(fixed, rel, "tail")])
    r = transe_rank._seq_abs_scores(table[pos][:, None, :], u)
    return table, u, r, pos


def offset_copy(table: torch.Tensor) -> torch.Tensor:
    """The same values in a view 4 bytes past a 16-byte boundary, which K1's
    variant rule sends to the "scalar" variant."""
    buf = torch.empty(table.numel() + 4, device=table.device)
    view = buf[1:1 + table.numel()].view(table.shape)
    view.copy_(table)
    return view


def k1_variant(table: torch.Tensor, u: torch.Tensor) -> str:
    return transe_rank.variant(table.shape[0], table.shape[1],
                               table.data_ptr(), u.data_ptr())


def check_k1() -> None:
    """At the flagship width and the word models' widths on the "tma"
    variant (d 300 is not a multiple of the 32-wide add chunk: its last
    chunk sums 12 dims), and at d 128 on the "scalar" variant."""
    n = 262_144
    for d in (K1_D, *WORD_DIMS):
        table, u, r, pos = k1_inputs(n, n - 1000, seed=1, d=d)
        want = transe_rank.raw_counts_plain(table, u, r, pos, n - 1000)
        tables = [table] + ([offset_copy(table)] if d == K1_D else [])
        for t, name in zip(tables, transe_rank.VARIANTS):
            require(k1_variant(t, u) == name, f"K1 variant rule at d={d}")
            got = transe_rank.raw_counts(t, u, r, pos, n - 1000)
            torch.cuda.synchronize()
            require(torch.equal(got, want),
                    f"K1 ({name}) counts differ from the plain version at d={d}")
            log(f"K1 check ({name}): Q={K1_Q} d={d} Np={n} num_valid="
                f"{n - 1000}: counts identical (sum gt={int(got[0].sum())}, "
                f"geq={int(got[1].sum())})")


def k2_inputs(b: int, seed: int, seg: int = SEG):
    _, nh, sp, hd = K2_SHAPE
    g = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v = (torch.randn((b, nh, sp, hd), generator=g, device="cuda")
               .to(torch.bfloat16) for _ in range(3))
    lens = torch.randint(1, seg + 1, (b, sp // seg), generator=g, device="cuda")
    # As in a padded final batch: about 1 row in 8 has its last one or two
    # segments empty (no real key), which the kernel runs against the whole
    # row.
    tail = torch.randint(0, 16, (b,), generator=g, device="cuda")
    lens[tail == 0, -2:] = 0
    lens[tail == 1, -1:] = 0
    mask = (torch.arange(seg, device="cuda")[None, None] < lens[:, :, None])
    return q, k, v, mask.reshape(b, sp).float()


def over_one_ulp(got: torch.Tensor, want: torch.Tensor) -> float:
    """Share of the elements of `got` more than one bf16 ulp of `want` away
    from it (the ulp of x in [2^(e-1), 2^e) is 2^(e-8))."""
    w = want.float()
    ulp = torch.ldexp(torch.ones_like(w), torch.frexp(w).exponent - 8)
    return ((got.float() - w).abs() > ulp).float().mean().item()


def check_k2() -> None:
    """At both segment lengths of the main path: max_len 32 (4 segments to a
    row) and the Wikidata5M keys' max_len 64 (2 segments)."""
    for seg in K2_SEGS:
        q, k, v, mask = k2_inputs(64, seed=2, seg=seg)
        scale = 1.0 / math.sqrt(q.shape[-1])
        got = packed_attention.block_diag_attention(q, k, v, mask, seg=seg,
                                                    scale=scale)
        want = packed_attention.block_diag_attention_plain(q, k, v, mask,
                                                           seg=seg, scale=scale)
        err = (got.float() - want.float()).abs().max().item()
        require(torch.allclose(got.float(), want.float(), rtol=2e-2, atol=2e-2),
                f"K2 differs from the plain version at seg {seg} (max abs err {err})")
        empty = int((mask.reshape(64, -1, seg).amax(-1) == 0).sum())
        log(f"K2 check: B=64 nh=12 Sp=128 hd=64 seg={seg}, {empty} segments "
            f"with no real key: max abs err {err:.3g} (tolerance 2e-2), "
            f"{100 * over_one_ulp(got, want):.4f}% of outputs more than 1 bf16 "
            f"ulp from the plain version")


def k3_inputs(b: int, seed: int, k: int = K3_K, adversarial: bool = False,
              d: int = K3_D):
    """fp32 entity and relation rows, and negatives from the port's sampler,
    or adversarial ones: row 0 on both sides of every third task, the own
    slots swapped, doubled, or kept (one own slot, as the sampler does)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    ent = torch.randn((2 * b, d), generator=g, device="cuda")
    rel = torch.randn((b, d), generator=g, device="cuda")
    if not adversarial:
        return ent, rel, sampling.sample_negative_indices(g, b, k, device="cuda")
    neg = torch.randint(0, 2 * b, (b, k, 2), generator=g, device="cuda",
                        dtype=torch.int32)
    own = 2 * torch.arange(b, dtype=torch.int32, device="cuda")
    neg[:, 0::3] = 0
    neg[:, 1::3, 0], neg[:, 1::3, 1] = (own + 1)[:, None], own[:, None]
    neg[:, 2::6, 0], neg[:, 2::6, 1] = own[:, None], own[:, None]
    neg[:, 5::6, 0] = own[:, None]
    return ent, rel, neg


def _margin_grads(fn, ent, rel, neg, rel_model, calls: int = 1):
    """Scores and margin-loss gradients; `calls` backward passes over one
    forward (each returns its own gradients)."""
    e = ent.clone().requires_grad_()
    r = rel.clone().requires_grad_()
    pos, negs = fn(e, r, neg, rel_model)
    loss = torch.relu(1.0 - pos + negs).mean() if negs.numel() else -pos.mean()
    grads = [torch.autograd.grad(loss, (e, r), retain_graph=True)
             for _ in range(calls)]
    return pos.detach(), negs.detach(), grads


def check_k3() -> dict:
    """(a) of the train phase: every scorer at both batch sizes (d 128) and
    at the word models' widths (B 64), on sampler indices and on adversarial
    ones (K 64 and K 0). Returns the largest forward and gradient errors per
    (batch size, width)."""
    errs = {}
    for b, d in [(b, K3_D) for b in K3_BATCHES] + [(64, d) for d in WORD_DIMS]:
        errs[b, d] = {"scores": 0.0, "grads": 0.0}
        cpu_equal = []
        for i, rel_model in enumerate(sddmm.MODELS):
            for k, adversarial in ((K3_K, False), (K3_K, True), (0, True)):
                what = (f"K3 {rel_model} B={b} d={d} K={k}"
                        f"{' adversarial' if adversarial else ''}")
                ent, rel, neg = k3_inputs(b, 10 + i, k, adversarial, d)
                pos, negs, grads = _margin_grads(sddmm.sddmm_scores, ent, rel,
                                                 neg, rel_model, calls=2)
                want = _margin_grads(sddmm.sddmm_scores_plain, ent, rel, neg,
                                     rel_model)
                torch.cuda.synchronize()
                for x, y in zip((pos, negs), want[:2]):
                    err = (x - y).abs().max().item() if x.numel() else 0.0
                    errs[b, d]["scores"] = max(errs[b, d]["scores"], err)
                    require(torch.allclose(x, y, rtol=1e-5, atol=1e-5),
                            f"{what}: scores differ from the plain version "
                            f"by {err}")
                for x, twice, y in zip(grads[0], grads[1], want[2][0]):
                    err = (x - y).abs().max().item()
                    errs[b, d]["grads"] = max(errs[b, d]["grads"], err)
                    require(torch.allclose(x, y, rtol=1e-5, atol=1e-6),
                            f"{what}: margin-loss gradients differ from plain "
                            f"autograd by {err} (rtol 1e-5, atol 1e-6)")
                    require(torch.equal(x, twice),
                            f"{what}: two backward calls differ")
                g_pos = torch.full((b, 1), 0.5, device="cuda")
                g_neg = torch.linspace(-1, 1, b * k, device="cuda").reshape(b, k)
                got = sddmm._sddmm_backward_kernel(ent, rel, neg, g_pos, g_neg,
                                                   rel_model)
                ref = sddmm.sddmm_scores_backward_plain(
                    ent.cpu(), rel.cpu(), neg.cpu(), g_pos.cpu(), g_neg.cpu(),
                    rel_model)
                cpu_equal.append(all(torch.equal(x.cpu(), y)
                                     for x, y in zip(got, ref)))
        log(f"K3 check: B={b} d={d} fp32, transe/distmult/complex/simple, "
            f"sampler K={K3_K}, adversarial K={K3_K} and K=0: scores max abs "
            f"err {errs[b, d]['scores']:.3g} (rtol = atol = 1e-5); margin-loss "
            f"gradients max abs err {errs[b, d]['grads']:.3g} against plain "
            f"autograd (rtol 1e-5, atol 1e-6), identical across two calls; "
            f"backward bit-identical to the CPU plain backward in "
            f"{sum(cpu_equal)} of {len(cpu_equal)} cases")
    return errs


def check_f2_one_launch() -> None:
    """F2's backward is one device launch (ds, dr, dscale and dbias): the
    device kernels torch.profiler records over calls at the W5M train
    step's 131,072 x 768 with 8-bit masks. Early in the run, where the
    profiler still records device events."""
    bf = torch.bfloat16
    eps = bert.BertConfig().layer_norm_eps
    x, r, scale, bias, gy = f2_inputs(W5M_TOKENS, True, bf, bf, seed=55)
    drop = _dropout(8, 12)
    with torch.no_grad():
        _, s, mean, rstd = fused_layer._add_layer_norm_kernel(x, r, scale, bias,
                                                              eps, bf, drop)
    ms, per_call, by_name = device_ms(
        lambda: fused_layer._add_layer_norm_backward_kernel(gy, s, mean, rstd,
                                                            scale, drop), reps=5)
    log(f"F2 backward at {W5M_TOKENS:,} x {BERT_H}, 8-bit masks: {per_call:g} "
        f"device launches a call, {ms:.4f} ms of device time: "
        f"{ {k[:60]: round(v, 4) for k, v in by_name.items()} }")
    require(per_call == 1 and by_name and all("add_ln_bwd" in k for k in by_name),
            f"F2's backward is not one add_ln_bwd launch a call: {per_call} "
            f"launches, {list(by_name)}")
    del x, r, s, gy
    torch.cuda.empty_cache()


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
    # Per further batch: device busy (nearly all of it the batches'), and the
    # rest of the wall, during which the device waits for the host.
    busy_per_batch = w5m_prof["busy_ms"] / n_long
    gap_ms = marginal_ms - busy_per_batch
    log(f"rank pass per further batch: wall {marginal_ms:.2f} ms, device busy "
        f"{busy_per_batch:.2f} ms ({100 * busy_per_batch / marginal_ms:.1f}%), host "
        f"gap {gap_ms:.2f} ms; per batch "
        f"{ {k: v / n_long for k, v in w5m_prof['host_waits'].items()} }")
    del table
    torch.cuda.empty_cache()
    return {"synth_mrr": res.mrr, "synth_mrr_filt": res.mrr_filt,
            "synth_hits_filt": res.hits_filt, "synth_eval_s": eval_s,
            "w5m_ms_per_batch": w_s * 1e3 / n_batches,
            "w5m_marginal_ms_per_batch": marginal_ms,
            "w5m_busy_ms_per_batch": busy_per_batch,
            "w5m_host_gap_ms_per_batch": gap_ms, "w5m_profile": w5m_prof}


# -- phase 6: train --------------------------------------------------------------

def train_model(num_relations: int, **enc_kw):
    """BERT-base BLP-TransE for training with K3: bf16, dropout 0.1 (32-bit
    masks), random weights from seed 0, BERT layers unstacked."""
    enc = bert.BertConfig(compute_dtype=torch.bfloat16, **enc_kw)
    cfg = blp.ModelConfig(model="blp", rel_model="transe", dim=128,
                          num_relations=num_relations, encoder=enc,
                          sddmm_pallas=True)
    params = training.unstack_params(blp.init_params(
        cfg, torch.Generator().manual_seed(0), device="cuda"))
    return cfg, params


def train_batches(data_dir: str, max_len: int, batch_size: int, n: int, *,
                  tokenizer=None, drop_stopwords: bool = False,
                  device: str = "cuda") -> list:
    tok = tokenizer or WordPieceTokenizer(os.path.join(data_dir, "vocab.txt"))
    data = TextGraphData.load(os.path.join(data_dir, "ind-train.tsv"),
                              tokenizer=tok, max_len=max_len,
                              drop_stopwords=drop_stopwords, write_maps=True)
    out = []
    for triples in epoch_batches(data, batch_size, rng=np.random.default_rng(0)):
        out.append(prefetch.to_device(text_train_batch(data, triples), device))
        if len(out) == n:
            return out
    raise SystemExit(f"FAILED: only {len(out)} batches of {batch_size}")


def flagship_train(data_dir: str) -> dict:
    """(b): the flagship train step, timed, profiled, and held against the
    same step without K3."""
    b, k = 64, 64
    cfg, params = train_model(12)
    opt = training.make_optimizer(2e-5, 1000)
    state = opt.init(params)
    step = training.make_train_step(cfg, opt, batch_size=b, num_negatives=k,
                                    device="cuda")
    batches = train_batches(data_dir, SEG, b, 23)
    losses = []
    for i in range(3):
        params, state, loss = step(params, state, (0, i), batches[i])
        losses.append(loss)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(3, 23):
        params, state, loss = step(params, state, (0, i), batches[i])
        losses.append(loss)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / 20
    losses = torch.stack(losses).cpu()
    require(bool(torch.isfinite(losses).all()), f"non-finite train loss {losses}")
    log(f"flagship train step (BERT-base bf16, B={b}, L={SEG}, K={k}, dropout "
        f"0.1, sddmm_pallas=True): {ms:.2f} ms per step over 20 steps = "
        f"{b * 1e3 / ms:,.0f} triples/s; losses {losses[0]:.4f} -> "
        f"{losses[-1]:.4f}, all finite")
    prof = device_profile("flagship train step",
                          lambda: step(params, state, (0, 23), batches[0]))

    # The same step without K3: same parameters, negatives and dropout seed.
    neg_seed, drop_seed = training.step_seeds((0, 24))
    batch = dict(batches[1], neg_idx=sampling.sample_negative_indices(
        torch.Generator(device="cuda").manual_seed(neg_seed), b, k, "cuda"))
    cfg_plain = dataclasses.replace(cfg, sddmm_pallas=False)
    loss_k, g_k = training.value_and_grad(params, cfg, batch, dropout_seed=drop_seed)
    loss_p, g_p = training.value_and_grad(params, cfg_plain, batch,
                                          dropout_seed=drop_seed)
    rel_loss = abs(loss_k.item() - loss_p.item()) / abs(loss_p.item())
    require(rel_loss <= 1e-4, f"sddmm_pallas on/off losses differ by {rel_loss}")
    for name in ("proj", "rel_emb"):
        err = (g_k[name] - g_p[name]).abs().max().item()
        require(torch.allclose(g_k[name], g_p[name], rtol=1e-3, atol=1e-6),
                f"sddmm_pallas on/off {name} gradients differ by {err}")
    log(f"flagship step with vs without K3: loss {loss_k.item():.6f} vs "
        f"{loss_p.item():.6f} (rel {rel_loss:.2g}, limit 1e-4); proj and rel_emb "
        f"gradients within rtol 1e-3, atol 1e-6 (max abs diff "
        f"{(g_k['proj'] - g_p['proj']).abs().max().item():.3g}, "
        f"{(g_k['rel_emb'] - g_p['rel_emb']).abs().max().item():.3g})")
    return {"train_ms_per_step": ms, "train_triples_per_s": b * 1e3 / ms,
            "train_losses": [round(float(x), 6) for x in losses],
            "train_profile": prof, "k3_on_off_rel_loss": rel_loss}


def w5m_train(data_dir: str, card: str) -> dict:
    """(c): the Wikidata5M operating point, B 1,024, L 64, remat=8."""
    b, k, seq = 1024, 64, 64
    cfg, params = train_model(12, remat=8)
    opt = training.make_optimizer(5e-5, 1000)
    state = opt.init(params)
    step = training.make_train_step(cfg, opt, batch_size=b, num_negatives=k,
                                    device="cuda")
    batches = train_batches(data_dir, seq, b, 3)
    torch.cuda.reset_peak_memory_stats()
    times, losses = [], []
    for i, batch in enumerate(batches):
        (params, state, loss), s = wall(lambda: step(params, state, (0, i), batch))
        times.append(s * 1e3)
        losses.append(loss.item())
    peak = torch.cuda.max_memory_allocated()
    require(all(math.isfinite(x) for x in losses), f"non-finite W5M loss {losses}")
    log(f"W5M train step (B={b}, L={seq}, remat=8, bf16, sddmm_pallas=True): "
        f"{[round(t, 1) for t in times]} ms for steps 1-3, "
        f"{b * 1e3 / times[-1]:,.0f} triples/s at step 3; peak memory "
        f"{peak / 2**30:.2f} GiB (max_memory_allocated) on {card}")
    prof = device_profile("W5M train step",
                          lambda: step(params, state, (0, 3), batches[0]))
    return {"w5m_train_ms": times, "w5m_train_peak_bytes": peak,
            "w5m_train_losses": losses, "w5m_train_profile": prof}


def cli_train(data_dir: str) -> dict:
    """(d): the link_prediction command, one epoch, then resume to two."""
    out_dir = os.path.join(WORK_DIR, "cli_out")
    argv = ["link_prediction", "with", f"data_dir={os.path.dirname(data_dir)}",
            f"dataset={os.path.basename(data_dir)}", f"out_dir={out_dir}",
            "run_id=smoke", "bf16=true", "device=cuda", "emb_batch_size=4096"]
    results = []
    for extra in (["max_epochs=1"], ["max_epochs=2", "resume=auto"]):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            (rc, s) = wall(lambda: train.main(argv + extra))
        require(rc == 0, f"link_prediction {extra} exited {rc}")
        results.append((json.loads(buf.getvalue().strip().splitlines()[-1]), s))
        if len(results) == 1:
            for name in ("metrics-smoke.jsonl", "model-smoke.npz",
                         "train_state-smoke.npz", "ent_emb-smoke.npz"):
                require(os.path.exists(os.path.join(out_dir, name)),
                        f"link_prediction wrote no {name}")
    rows = [json.loads(line) for line in
            open(os.path.join(out_dir, "metrics-smoke.jsonl"))]
    epochs = [r["step"] for r in rows if "train_loss" in r]
    require(epochs == [1, 2], f"trained epochs {epochs}, expected [1, 2]")
    tput = [r["triples_per_sec"] for r in rows if "triples_per_sec" in r]
    for (res, s), ep in zip(results, (1, 2)):
        require(math.isfinite(res["test_mrr_filt"]),
                f"link_prediction epoch {ep}: test_mrr_filt {res['test_mrr_filt']}")
    log(f"link_prediction (BERT-base bf16, synthetic graph): epoch 1 in "
        f"{results[0][1]:.1f} s incl. evals ({tput[0]:,.0f} triples/s in the "
        f"epoch), test MRR filtered {results[0][0]['test_mrr_filt']:.4f}; "
        f"resume=auto ran epoch 2 only ({results[1][1]:.1f} s, "
        f"{tput[1]:,.0f} triples/s), test MRR filtered "
        f"{results[1][0]['test_mrr_filt']:.4f}")
    return {"cli_epoch_s": [s for _, s in results], "cli_triples_per_s": tput,
            "cli_test_mrr_filt": [r["test_mrr_filt"] for r, _ in results]}


def train_phase(data_dir: str, card: str) -> dict:
    stats = flagship_train(data_dir)
    torch.cuda.empty_cache()
    stats.update(w5m_train(data_dir, card))
    torch.cuda.empty_cache()
    stats.update(cli_train(data_dir))
    return stats


# -- phase 8: the word-embedding models ------------------------------------------

def word_model(model: str, emb_dim: int, num_relations: int, *,
               vocab_size: int = 0, word_embeddings=None, device: str = "cuda"):
    """A word-embedding model with K3 (TransE, dim 128, regularizer 1e-2,
    fp32, as scripts/*-{bow,dkrl}-*.sh run): random weights from seed 0 on
    the device, or the given word table."""
    cfg = blp.ModelConfig(model=model, rel_model="transe", dim=128,
                          num_relations=num_relations, regularizer=1e-2,
                          emb_dim=emb_dim, vocab_size=vocab_size,
                          sddmm_pallas=True)
    params = blp.init_params(cfg, torch.Generator(device=device).manual_seed(0),
                             device=device, word_embeddings=word_embeddings)
    return cfg, params


def timed_steps(label: str, cfg, params, batches, *, lr: float, batch_size: int,
                warmup: int, device: str = "cuda") -> dict:
    """`warmup` steps, then the rest of `batches` timed (host clock around
    work that ends in a synchronize), finite losses, one step profiled.
    Returns the stats and the trained params."""
    opt = training.make_optimizer(lr, 1000, use_scheduler=False)
    state = opt.init(params)
    step = training.make_train_step(cfg, opt, batch_size=batch_size,
                                    num_negatives=K3_K, device=device)
    torch.cuda.reset_peak_memory_stats()
    losses, times = [], []
    for i in range(warmup):
        (params, state, loss), s = wall(lambda: step(params, state, (0, i),
                                                     batches[i]))
        losses.append(loss)
        times.append(s * 1e3)
    t0 = time.perf_counter()
    for i in range(warmup, len(batches)):
        params, state, loss = step(params, state, (0, i), batches[i])
        losses.append(loss)
    torch.cuda.synchronize()
    timed = len(batches) - warmup
    ms = (time.perf_counter() - t0) * 1e3 / timed
    peak = torch.cuda.max_memory_allocated()
    losses = torch.stack(losses).cpu()
    require(bool(torch.isfinite(losses).all()), f"{label}: non-finite loss {losses}")
    log(f"{label}: warm-up steps {[round(t, 1) for t in times]} ms, then "
        f"{ms:.2f} ms per step over {timed} steps = "
        f"{batch_size * 1e3 / ms:,.0f} triples/s; peak memory "
        f"{peak / 2**30:.2f} GiB (max_memory_allocated); losses "
        f"{losses[0]:.4f} -> {losses[-1]:.4f}, all finite")
    prof = device_profile(label, lambda: step(params, state, (0, len(batches)),
                                              batches[0]))
    return {"ms_per_step": ms, "triples_per_s": batch_size * 1e3 / ms,
            "warmup_ms": times, "peak_bytes": peak,
            "losses": [round(float(x), 6) for x in losses],
            "profile": prof}, params


def dkrl_fb15k237(data_dir: str, device: str = "cuda") -> dict:
    """(a): bert-dkrl at the keys of scripts/bert-dkrl-fb15k237.sh (emb 768,
    dim 128, bert-base-cased's 28,996-row word table, B 64, L 32, K 64, lr
    1e-4, no scheduler): 3 warm-up and 20 timed steps, a profile, and the
    same step without K3 from the same parameters and seeds."""
    b = 64
    cfg, params = word_model("bert-dkrl", 768, 12, vocab_size=BERT_VOCAB,
                             device=device)
    tok = WordPieceTokenizer(os.path.join(data_dir, "vocab.txt"))
    batches = train_batches(data_dir, SEG, b, 23, tokenizer=tok,
                            drop_stopwords=True, device=device)
    run, params = timed_steps(f"bert-dkrl train step (B={b}, L={SEG}, K={K3_K}, emb "
                      f"768, fp32, sddmm_pallas=True)", cfg, params, batches,
                      lr=1e-4, batch_size=b, warmup=3, device=device)
    neg_seed, drop_seed = training.step_seeds((0, 24))
    batch = dict(batches[1], neg_idx=sampling.sample_negative_indices(
        torch.Generator(device=device).manual_seed(neg_seed), b, K3_K, device))
    loss_k, g_k = training.value_and_grad(params, cfg, batch,
                                          dropout_seed=drop_seed)
    loss_p, g_p = training.value_and_grad(
        params, dataclasses.replace(cfg, sddmm_pallas=False), batch,
        dropout_seed=drop_seed)
    rel_loss = abs(loss_k.item() - loss_p.item()) / abs(loss_p.item())
    require(rel_loss <= 1e-4, f"bert-dkrl sddmm_pallas on/off losses differ "
            f"by {rel_loss}")
    grad_diff = {k: (g_k[k] - g_p[k]).abs().max().item()
                 for k in ("rel_emb", "word_emb")}
    log(f"bert-dkrl step with vs without K3: loss {loss_k.item():.6f} vs "
        f"{loss_p.item():.6f} (rel {rel_loss:.2g}, limit 1e-4); max abs "
        f"gradient diff {grad_diff}")
    return {**{"dkrl_fb15k237_" + k: v for k, v in run.items()},
            "dkrl_k3_on_off_rel_loss": rel_loss}


def dkrl_w5m(data_dir: str, glove_maps: str, device: str = "cuda") -> dict:
    """(b): glove-dkrl at the keys of scripts/glove-dkrl-wikidata5m.sh (B
    1,024, L 64, emb 300, a 400,000-row word table as GloVe 6B's, random
    from seed 0): 3 steps, ms per step, peak memory, a profile."""
    b, seq = 1024, 64
    cfg, params = word_model("glove-dkrl", 300, 12, vocab_size=GLOVE_ROWS,
                             device=device)
    batches = train_batches(data_dir, seq, b, 3, tokenizer=GloVeTokenizer(glove_maps),
                            drop_stopwords=True, device=device)
    run, _ = timed_steps(f"glove-dkrl W5M train step (B={b}, L={seq}, K={K3_K}, "
                      f"emb 300, {GLOVE_ROWS:,}-row word table, fp32, "
                      f"sddmm_pallas=True)", cfg, params, batches, lr=1e-4,
                      batch_size=b, warmup=2, device=device)
    return {"dkrl_w5m_" + k: v for k, v in run.items()}


def bow_eval(data_dir: str, glove_maps: str, glove_table: str,
             device: str = "cuda") -> dict:
    """(c): glove-bow (entity width 300, the GloVe table of `glove_table`)
    and bert-bow (768, a 28,996-row random table): one train step each
    (B 64, L 32, K 64), then the two-phase filtered evaluation of the
    4,096-entity synthetic graph on the card, and its first
    BOW_EVAL_BATCHES batches held equal to the CPU plain paths on the same
    table."""
    out = {}
    for model, emb_dim, lr in (("glove-bow", 300, 1e-3), ("bert-bow", 768, 1e-4)):
        if model == "glove-bow":
            tok = GloVeTokenizer(glove_maps)
            cfg, params = word_model(model, emb_dim, 12, device=device,
                                     word_embeddings=torch.load(glove_table))
        else:
            tok = WordPieceTokenizer(os.path.join(data_dir, "vocab.txt"))
            cfg, params = word_model(model, emb_dim, 12, vocab_size=BERT_VOCAB,
                                     device=device)
        batch = train_batches(data_dir, SEG, 64, 1, tokenizer=tok,
                              drop_stopwords=True, device=device)[0]
        opt = training.make_optimizer(lr, 1000, use_scheduler=False)
        step = training.make_train_step(cfg, opt, batch_size=64,
                                        num_negatives=K3_K, device=device)
        params, _, loss = step(params, opt.init(params), (0, 0), batch)
        require(math.isfinite(loss.item()), f"{model}: train loss {loss.item()}")

        train = TextGraphData.load(os.path.join(data_dir, "ind-train.tsv"),
                                   tokenizer=tok, max_len=SEG, drop_stopwords=True,
                                   write_maps=True)
        test = GraphData.load(os.path.join(data_dir, "ind-test.tsv"))
        dev = GraphData.load(os.path.join(data_dir, "ind-dev.tsv"))
        entities = np.arange(len(train.ent_ids))
        kw = dict(filter_index=FilterIndex(np.concatenate(
                      [train.triples, dev.triples, test.triples])),
                  new_entities=np.setdiff1d(entities, train.entities),
                  rel_categories=train.rel_categories, batch_size=64)
        res, eval_s = wall(lambda: evaluation.eval_link_prediction(
            params, cfg, test.triples, train, entities, emb_batch_size=4096,
            return_embeddings=True, device=device, **kw))
        part = evaluation.eval_link_prediction(
            params, cfg, test.triples, train, entities, ent_emb=res.ent_emb,
            max_num_batches=BOW_EVAL_BATCHES, device=device, **kw)
        ref = evaluation.eval_link_prediction(
            {"rel_emb": params["rel_emb"].cpu()}, cfg, test.triples, train,
            entities, ent_emb=res.ent_emb, max_num_batches=BOW_EVAL_BATCHES,
            device="cpu", **kw)
        require(ref.scalars("x") == part.scalars("x"),
                f"{model}: card and CPU evaluations of the same table differ")
        log(f"{model} (d {cfg.entity_dim}): one train step, loss "
            f"{loss.item():.4f}; eval ({len(test.triples)} test triples, "
            f"{len(entities)} candidates) {eval_s:.2f} s, MRR {res.mrr:.4f} "
            f"filtered {res.mrr_filt:.4f}; its first {BOW_EVAL_BATCHES} batches "
            f"equal the CPU plain paths on the same table")
        out[f"{model}_eval_s"] = eval_s
        out[f"{model}_mrr_filt"] = res.mrr_filt
    return out


def write_ir_files(directory: str, vocab_file: str) -> dict:
    """Synthetic files the size of DBpedia-Entity v2, from seed 0: its
    queries, the top BM25F candidates of each (each with a description of
    5-30 words), graded qrels (0-2) on 30 candidates and 5 other entities
    of each query, and its folds. Returns the paths."""
    queries, per_query, folds = IR_QUERIES, IR_CANDIDATES, IR_FOLDS
    rng = np.random.default_rng(0)
    os.makedirs(directory, exist_ok=True)
    words = np.array([w for w in open(vocab_file).read().split()
                      if w.isalpha()])
    paths = {k: os.path.join(directory, name) for k, name in (
        ("run_file", "bm25f.run"), ("queries_file", "queries.txt"),
        ("descriptions_file", "descriptions.txt"), ("qrels_file", "qrels.txt"),
        ("folds_file", "folds.json"))}
    qids = [f"Q{i:03d}" for i in range(queries)]
    n_ent = queries * per_query
    lens = rng.integers(5, 31, n_ent)
    picks = rng.integers(0, len(words), int(lens.sum()))
    with open(paths["descriptions_file"], "w") as f:
        at = 0
        for e, n in enumerate(lens):
            f.write(f"<dbpedia:E{e}>\t{' '.join(words[picks[at:at + n]])}\n")
            at += n
    with open(paths["queries_file"], "w") as f:
        for q in qids:
            f.write(f"{q}\t{' '.join(rng.choice(words, int(rng.integers(2, 7))))}\n")
    with open(paths["run_file"], "w") as f, open(paths["qrels_file"], "w") as g:
        for qi, q in enumerate(qids):
            scores = np.sort(rng.uniform(5, 40, per_query))[::-1]
            for rank in range(per_query):
                f.write(f"{q} Q0 <dbpedia:E{qi * per_query + rank}> {rank + 1} "
                        f"{scores[rank]:.4f} bm25f\n")
            judged = np.concatenate([
                qi * per_query + rng.choice(per_query, 30, replace=False),
                rng.integers(0, n_ent, 5)])
            for e in judged:
                g.write(f"{q} 0 <dbpedia:E{e}> {rng.choice(3, p=[0.6, 0.25, 0.15])}\n")
    with open(paths["folds_file"], "w") as f:
        json.dump({str(i): {"training": [q for j, q in enumerate(qids) if j % folds != i],
                            "testing": [q for j, q in enumerate(qids) if j % folds == i]}
                   for i in range(folds)}, f)
    return paths


def cli_chain(data_dir: str, device: str = "cuda") -> dict:
    """(d): `link_prediction` with model=bert-dkrl for one epoch (the keys of
    scripts/bert-dkrl-fb15k237.sh), `node_classification` on its export,
    and the retrieval reranker with that checkpoint on DBpedia-Entity v2
    sized synthetic files; each in-process, timed."""
    out_dir = os.path.join(WORK_DIR, "word_cli")
    common = [f"data_dir={os.path.dirname(data_dir)}",
              f"dataset={os.path.basename(data_dir)}", f"out_dir={out_dir}",
              f"device={device}"]
    lp = ["link_prediction", "with", *common, "model=bert-dkrl", "dim=128",
          "regularizer=1e-2", "max_len=32", "num_negatives=64", "lr=1e-4",
          "use_scheduler=false", "batch_size=64", "emb_batch_size=4096",
          "eval_batch_size=64", "max_epochs=1", "run_id=dkrl"]
    nc = ["node_classification", "with", *common, "checkpoint=dkrl"]
    results = {}
    for name, argv in (("link_prediction", lp), ("node_classification", nc)):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc, s = wall(lambda: train.main(argv))
        require(rc == 0, f"{name} exited {rc}")
        results[name] = (json.loads(buf.getvalue().strip().splitlines()[-1]), s)
    lp_res, lp_s = results["link_prediction"]
    nc_res, nc_s = results["node_classification"]
    require(math.isfinite(lp_res["test_mrr_filt"]),
            f"bert-dkrl link_prediction test_mrr_filt {lp_res['test_mrr_filt']}")
    require(all(0.0 <= nc_res[k] <= 1.0 for k in nc_res if k != "best_c"),
            f"node_classification {nc_res}")
    log(f"link_prediction (bert-dkrl, fp32, 1 epoch, synthetic graph): "
        f"{lp_s:.1f} s incl. evals, test MRR filtered "
        f"{lp_res['test_mrr_filt']:.4f}; node_classification on its export: "
        f"{nc_s:.1f} s, {nc_res}")

    files, files_s = wall(lambda: write_ir_files(
        os.path.join(WORK_DIR, "dbpedia_synth"),
        os.path.join(data_dir, "vocab.txt")))
    rcfg = retrieval.RetrievalConfig(
        model="bert-dkrl", dim=128, checkpoint=lp_res["checkpoint"],
        vocab_file=os.path.join(data_dir, "vocab.txt"), out_dir=out_dir,
        run_id="rerank", device=device, **files)
    rr, rr_s = wall(lambda: retrieval.rerank(rcfg))
    for k in (10, 100):
        # The t-test has no p-value when every fold picked alpha 0 (the
        # reranked run is the baseline).
        same = rr[f"ndcg@{k}"] == rr[f"ndcg@{k}_baseline"]
        require(0.0 <= rr[f"ndcg@{k}"] <= 1.0
                and (math.isfinite(rr[f"ndcg@{k}_pvalue"]) or same),
                f"rerank NDCG@{k} {rr[f'ndcg@{k}']}, p {rr[f'ndcg@{k}_pvalue']}")
    lines = sum(1 for _ in open(rr["run_file"]))
    require(lines == IR_QUERIES * IR_CANDIDATES,
            f"rerank run file has {lines} lines")
    log(f"rerank (bert-dkrl, {IR_QUERIES} queries x {IR_CANDIDATES} "
        f"candidates, {IR_FOLDS} folds; files "
        f"written in {files_s:.1f} s): {rr_s:.1f} s; NDCG@10 "
        f"{rr['ndcg@10_baseline']:.4f} -> {rr['ndcg@10']:.4f} (p "
        f"{rr['ndcg@10_pvalue']:.3g}), NDCG@100 {rr['ndcg@100_baseline']:.4f} "
        f"-> {rr['ndcg@100']:.4f} (p {rr['ndcg@100_pvalue']:.3g}); seconds "
        f"{ {k: round(v, 2) for k, v in rr['seconds'].items()} }")
    return {"cli_dkrl_epoch_s": lp_s, "cli_dkrl_test_mrr_filt": lp_res["test_mrr_filt"],
            "node_classification_s": nc_s, "node_classification": nc_res,
            "rerank_s": rr_s, "rerank_seconds": rr["seconds"],
            **{k: rr[k] for k in rr if k.startswith("ndcg")}}


def word_phase(data_dir: str, device: str = "cuda") -> dict:
    glove = write_tiny_glove(os.path.join(WORK_DIR, "glove"),
                             os.path.join(data_dir, "vocab.txt"), dim=300)
    maps = glove.replace(".pt", "-maps.pt")
    stats = dkrl_fb15k237(data_dir, device)
    torch.cuda.empty_cache()
    stats.update(dkrl_w5m(data_dir, maps, device))
    torch.cuda.empty_cache()
    stats.update(bow_eval(data_dir, maps, glove, device=device))
    torch.cuda.empty_cache()
    stats.update(cli_chain(data_dir, device))
    return stats


# -- phase 9: the multi-device paths -----------------------------------------------

#: Ranks of the multi-rank checks. The card's machine has one H100, so the
#: ranks share it (gloo: NCCL refuses two ranks on one device); their times
#: are checks of the paths, not scaling figures.
RANKS = 2
W5M_BATCHES = 30
#: The CPU tests' tolerances of a parallel step against the one-device step.
STEP_RTOL, STEP_ATOL, LOSS_RTOL = 2e-5, 2e-6, 1e-5
#: The multi-rank train steps' learning rate (the flagship run's; constant).
MESH_LR = 2e-5
#: This process's device and the ranks' (all on the one card).
DEVICE, RANK_DEVICE = "cuda", "cuda:0"


def remat_policies(data_dir: str) -> dict:
    """(a): the flagship step under remat False, True, "dots" and "names":
    gradients bit-equal to remat=False (dropout on), ms per step and peak
    memory."""
    b, k = 64, 64
    batches = train_batches(data_dir, SEG, b, 12, device=DEVICE)
    out, ref = {}, None
    for remat in (False, True, "dots", "names"):
        cfg, params = train_model(12, remat=remat)
        neg_seed, drop_seed = training.step_seeds((0, 0))
        batch = dict(batches[0], neg_idx=sampling.sample_negative_indices(
            torch.Generator(device=DEVICE).manual_seed(neg_seed), b, k, DEVICE))
        _, grads = training.value_and_grad(params, cfg, batch,
                                           dropout_seed=drop_seed)
        grads = _leaves(grads)
        if ref is None:
            ref = grads
        else:
            same = [torch.equal(a, g) for a, g in zip(ref, grads)]
            require(all(same), f"remat={remat!r}: {same.count(False)} of "
                    f"{len(same)} gradient leaves differ from remat=False")
        del grads
        opt = training.make_optimizer(2e-5, 1000)
        state = opt.init(params)
        step = training.make_train_step(cfg, opt, batch_size=b,
                                        num_negatives=k, device=DEVICE)
        for i in range(2):
            params, state, loss = step(params, state, (0, i), batches[i])
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        for i in range(2, 12):
            params, state, loss = step(params, state, (0, i), batches[i])
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / 10
        peak = torch.cuda.max_memory_allocated() / 2**30
        require(math.isfinite(loss.item()), f"remat={remat!r}: loss {loss.item()}")
        out[str(remat)] = {"ms_per_step": ms, "peak_gib": peak}
        log(f"remat={remat!r}: {ms:.2f} ms per step (10 steps), peak "
            f"{peak:.2f} GiB; gradients "
            + ("the reference" if remat is False else "bit-equal to remat=False"))
        del params, state, step
        torch.cuda.empty_cache()
    return {"remat": out}


def _w5m_inputs(device):
    """The Wikidata5M-scale rank pass's table, triples and filters (the same
    from seed 5 in every process)."""
    g = torch.Generator(device=device).manual_seed(5)
    n, b, num_rels = W5M_ENTITIES, 64, 16
    table = torch.randn((n, K1_D), generator=g, device=device)
    table /= table.norm(dim=1, keepdim=True)
    rel = 0.1 * torch.randn((num_rels, K1_D), generator=g, device=device)
    rng = np.random.default_rng(5)
    trip = np.stack([rng.integers(0, n, b * W5M_BATCHES),
                     rng.integers(0, n, b * W5M_BATCHES),
                     rng.integers(0, num_rels, b * W5M_BATCHES)], axis=1)
    extra = []
    for h, t, r in trip:  # 40 known answers each way -> 64 filter columns
        extra.append(np.stack([np.full(40, h), rng.integers(0, n, 40),
                               np.full(40, r)], axis=1))
        extra.append(np.stack([rng.integers(0, n, 40), np.full(40, t),
                               np.full(40, r)], axis=1))
    return table, rel, trip, FilterIndex(np.concatenate([trip] + extra))


def w5m_counts(table, rel, trip, fidx, shard=None) -> np.ndarray:
    """The (batches, 8, 64) int32 counts of the rank pass over `table` (the
    whole, or this rank's block with `shard`), batch by batch."""
    from blp_tpu_torch.data.filtering import build_filters

    n = W5M_ENTITIES
    dev = table.device
    ent2idx = np.arange(n)
    hf_all, tf_all = build_filters(trip, fidx, ent2idx)
    pad = max(hf_all.shape[1], tf_all.shape[1])
    out = []
    for i in range(W5M_BATCHES):
        bt = trip[i * 64:(i + 1) * 64]
        hf, tf = build_filters(bt, fidx, ent2idx, pad_width=pad)
        on = lambda a, dt=torch.int64: torch.as_tensor(a).to(dev, dt)  # noqa: E731
        c = evaluation._rank_batch(
            table, on(bt[:, 0]), on(bt[:, 1]), rel, on(bt[:, 2]), n,
            on(hf, torch.int32), on(tf, torch.int32), rel_model="transe",
            tile=65536, shard=shard)
        out.append(torch.stack([c[k] for k in sorted(c)]))
    return torch.stack(out).cpu().numpy()


def _mesh_rank(rank: int, n_ranks: int, rank_device: str, store: str,
               data_dir: str, ref_path: str, out_path: str) -> None:
    """One of n_ranks processes on rank_device (cuda:0 for all: gloo;
    "cuda": a card each, NCCL): (b) the sharded rank pass at Wikidata5M
    scale and the sharded phase-1 encode, (c) one DP, TP and PP train step
    each against the one-device step stored at ref_path."""
    from torch.profiler import ProfilerActivity, profile

    from blp_tpu_torch.parallel import comm, eval_parallel, pipeline
    from blp_tpu_torch.parallel import mesh as mesh_lib
    from blp_tpu_torch.parallel import train_parallel

    torch.backends.cuda.matmul.allow_tf32 = False
    os.environ["LOCAL_RANK"] = str(rank)      # one host
    dev = comm.init_world(rank_device, init_method=f"file://{store}",
                          world_size=n_ranks, rank=rank)
    res = {}
    # Host seconds inside the collectives of the sharded rank pass.
    spent = [0.0]

    def timed(fn):
        def run(*a, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                spent[0] += time.perf_counter() - t0
        return run

    # (b) the rank pass at Wikidata5M scale, each rank counting its block.
    table, rel, trip, fidx = _w5m_inputs(dev)
    mesh = mesh_lib.make_mesh(n_ranks, 1, device=dev)
    n_pad = -(-W5M_ENTITIES // (65536 * n_ranks)) * 65536 * n_ranks
    shard = eval_parallel.Shard.of(mesh, n_pad)
    block = shard.pad(table[shard.offset:shard.offset + shard.rows])
    del table
    torch.cuda.empty_cache()
    w5m_counts(block, rel, trip, fidx, shard)        # warm-up
    torch.cuda.synchronize()
    plain = (comm.all_gather, comm.all_reduce)
    comm.all_gather, comm.all_reduce = timed(plain[0]), timed(plain[1])
    try:
        t0 = time.perf_counter()
        res["w5m_counts"] = w5m_counts(block, rel, trip, fidx, shard)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    finally:
        comm.all_gather, comm.all_reduce = plain
    comm_ms = spent[0] * 1e3
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        w5m_counts(block, rel, trip, fidx, shard)
        torch.cuda.synchronize()
    k1_ms = sum(e.self_device_time_total for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA
                and "transe_rank" in e.key.lower()) / 1e3
    res["w5m"] = {"ms_per_batch": wall_ms / W5M_BATCHES,
                  "k1_ms_per_batch": k1_ms / W5M_BATCHES,
                  "collective_host_ms_per_batch": comm_ms / W5M_BATCHES,
                  "block_rows": shard.rows}
    del block
    torch.cuda.empty_cache()

    # (b) the sharded phase-1 encode of the synthetic graph, K2 on each rank.
    cfg, params = make_model(12)
    tok = WordPieceTokenizer(os.path.join(data_dir, "vocab.txt"))
    train = TextGraphData.load(os.path.join(data_dir, "ind-train.tsv"),
                               tokenizer=tok, max_len=SEG)
    test = GraphData.load(os.path.join(data_dir, "ind-test.tsv"))
    dev_g = GraphData.load(os.path.join(data_dir, "ind-dev.tsv"))
    entities = np.arange(len(train.ent_ids))
    fidx = FilterIndex(np.concatenate([train.triples, dev_g.triples, test.triples]))
    r, s = wall(lambda: evaluation.eval_link_prediction(
        params, cfg, test.triples, train, entities, batch_size=64,
        emb_batch_size=4096, filter_index=fidx, return_embeddings=True,
        mesh=mesh, device=dev))
    res["encode"] = {"table": r.ent_emb, "scalars": r.scalars("x"), "s": s}
    del params
    torch.cuda.empty_cache()

    # (c) train steps: DP 2 x 1, TP 1 x 2, PP 1 x 2 with 4 microbatches.
    ref = torch.load(ref_path, weights_only=False)
    batch = {k: v.to(dev) for k, v in ref["batch"].items()}
    b = len(batch["rels"])
    neg_seed, drop_seed = training.step_seeds((0, 0))
    neg = sampling.sample_negative_indices(
        torch.Generator(device=dev).manual_seed(neg_seed), b, 64, dev)
    res["steps"] = {}
    for name, shape in (("dp", (n_ranks, 1)), ("tp", (1, n_ranks)),
                        ("pp", (1, n_ranks))):
        tcfg, full = fp32_model()
        opt = training.make_optimizer(MESH_LR, 1000, use_scheduler=False)
        if name == "pp":
            mesh = pipeline.make_pipeline_mesh(*shape, device=dev)
            params = pipeline.shard_pipeline_params(training.restack_params(full),
                                                    mesh)
            step = pipeline.make_pipeline_train_step(
                tcfg, opt, mesh=mesh, batch_size=b, num_negatives=64,
                num_microbatches=4, device=dev)
            value_and_grad = functools.partial(
                pipeline.pipeline_value_and_grad, mesh=mesh, num_microbatches=4)
            gather = lambda p: pipeline.gather_pipeline_params(p, mesh)  # noqa: E731
        else:
            mesh = mesh_lib.make_mesh(*shape, device=dev)
            params, _, split = train_parallel.init_parallel_state(
                full, opt, mesh, tensor_parallel=name == "tp")
            step = train_parallel.make_parallel_train_step(
                tcfg, opt, mesh=mesh, batch_size=b, num_negatives=64, device=dev)
            value_and_grad = functools.partial(
                train_parallel.parallel_value_and_grad,
                data=train_parallel.axis(mesh, "data"),
                model=train_parallel.model_axis(mesh))
            gather = lambda p: training.restack_params(  # noqa: E731
                train_parallel.gather_state(p, mesh, split))
        del full
        rows = train_parallel.local_rows(b, train_parallel.axis(mesh, "data"))
        local = {k: v[rows] for k, v in batch.items()}
        # The step's loss and gradients, held to one process's.
        loss, grads = value_and_grad(params, tcfg, dict(local, neg_idx=neg),
                                     dropout_seed=drop_seed)
        grads = _leaves(gather(grads))
        excess = max(((g - w.to(dev)).abs() - (STEP_ATOL + STEP_RTOL * w.to(dev).abs())
                      ).max().item() for g, w in zip(grads, ref["grads"]))
        del grads
        # The whole step, timed; its parameters against one process's.
        state = opt.init(params)
        times = []
        for i in range(3):
            (p1, s1, _), t = wall(lambda: step(params, state, (0, 0), local))
            times.append(t * 1e3)
            if i == 0:
                got = _leaves(gather(p1))
            del p1, s1
        beyond, g_beyond, max_abs = 0, 0.0, 0.0
        for x, w, g in zip(got, ref["params"], ref["grads"]):
            w, g = w.to(dev), g.to(dev)
            out = (x - w).abs() > STEP_ATOL + STEP_RTOL * w.abs()
            beyond += int(out.sum())
            if out.any():
                g_beyond = max(g_beyond, g[out].abs().max().item())
            max_abs = max(max_abs, (x - w).abs().max().item())
        res["steps"][name] = {"loss": loss.item(), "ms": times,
                              "grad_excess": excess, "param_max_abs": max_abs,
                              "params_beyond": beyond, "grad_at_beyond": g_beyond}
        del params, step, got
        torch.cuda.empty_cache()
    res["launches"] = read_counts()
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()
    with open(out_path % rank, "wb") as f:
        import pickle
        pickle.dump(res, f)


def fp32_model():
    """BERT-base BLP-TransE in fp32 with K3 and dropout 0.1, random weights
    from seed 0, layers unstacked (the multi-rank steps' model)."""
    cfg = blp.ModelConfig(model="blp", rel_model="transe", dim=128,
                          num_relations=12, encoder=bert.BertConfig(),
                          sddmm_pallas=True)
    params = training.unstack_params(blp.init_params(
        cfg, torch.Generator().manual_seed(0), device=DEVICE))
    return cfg, params


def _placement(rank_device: str) -> str:
    dev = torch.device(rank_device)
    if dev.type != "cuda":
        return "the CPU (gloo)"
    return "a card each (NCCL)" if dev.index is None else "one card (gloo)"


def mesh_cli(data_dir: str, n_ranks: int = RANKS,
             rank_device: str = RANK_DEVICE) -> dict:
    """(d): link_prediction under torch.distributed.run with n_ranks ranks on
    rank_device and num_data_shards=n_ranks for one epoch (the tiny
    encoder), then resume=auto on one process for the second."""
    out_dir = os.path.join(WORK_DIR, "mesh_cli")
    shutil.rmtree(out_dir, ignore_errors=True)
    args = ["link_prediction", "with", f"data_dir={os.path.dirname(data_dir)}",
            f"dataset={os.path.basename(data_dir)}", f"out_dir={out_dir}",
            "run_id=mesh", "encoder_name=tiny", "emb_batch_size=4096"]
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           f"--nproc-per-node={n_ranks}", "-m", "blp_tpu_torch.train", *args,
           f"num_data_shards={n_ranks}", f"device={rank_device}", "max_epochs=2",
           "stop_after_epochs=1"]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600,
                          cwd=ROOT)
    run_s = time.perf_counter() - t0
    require(proc.returncode == 0, f"torch.distributed.run link_prediction exited "
            f"{proc.returncode}: {proc.stderr[-3000:]}")
    mesh_res = [json.loads(ln) for ln in proc.stdout.strip().splitlines()
                if ln.startswith("{")]
    require(len(mesh_res) == n_ranks and all(r == mesh_res[0] for r in mesh_res),
            f"ranks returned {mesh_res}")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        (rc, res_s) = wall(lambda: train.main(
            args + [f"device={DEVICE}", "max_epochs=2", "resume=auto"]))
    require(rc == 0, f"resume on one process exited {rc}")
    one = json.loads(buf.getvalue().strip().splitlines()[-1])
    rows = [json.loads(line) for line in
            open(os.path.join(out_dir, "metrics-mesh.jsonl"))]
    epochs = [r["step"] for r in rows if "train_loss" in r]
    require(epochs == [1, 2], f"trained epochs {epochs}, expected [1, 2]")
    require(math.isfinite(one["test_mrr_filt"]), f"resumed run: {one}")
    log(f"link_prediction under torch.distributed.run ({n_ranks} ranks on "
        f"{_placement(rank_device)}, num_data_shards={n_ranks}, tiny encoder): "
        f"epoch 1 and evals "
        f"{run_s:.1f} s (launcher included), test MRR filtered "
        f"{mesh_res[0]['test_mrr_filt']:.4f}; resume=auto on one process ran "
        f"epoch 2 ({res_s:.1f} s), test MRR filtered {one['test_mrr_filt']:.4f}")
    return {"mesh_cli_s": run_s, "mesh_cli_resume_s": res_s,
            "mesh_cli_test_mrr_filt": [mesh_res[0]["test_mrr_filt"],
                                       one["test_mrr_filt"]]}


def mesh_phase(data_dir: str, cfg, read_counts) -> tuple[dict, dict]:
    """Phase 9. Returns its stats and the kernel launches of its paths, as
    read_counts gives them: this process's remat steps and its resume of the
    distributed CLI run, and the ranks' passes and steps. The one-process
    passes the ranks are held to, and the CLI's own ranks, are not counted."""
    stats = remat_policies(data_dir)
    here = read_counts()
    torch.cuda.empty_cache()
    rank_stats, rank_launches = mesh_ranks(data_dir, cfg)
    stats.update(rank_stats)
    before = read_counts()
    stats.update(mesh_cli(data_dir))
    after = read_counts()
    return stats, {k: here[k] + rank_launches[k] + (after[k] - before[k])
                   for k in here}


def mesh_ranks(data_dir: str, cfg, n_ranks: int = RANKS,
               rank_device: str = RANK_DEVICE) -> tuple[dict, dict]:
    """(b) and (c) of phase 9 over n_ranks ranks on rank_device, held to
    this process's one-device passes. Returns the stats and the ranks'
    kernel launches summed, K1's also by (variant, d) and K2's by segment
    length."""
    import pickle

    # The one-device step the ranks' steps are held to (fp32, dropout on).
    tcfg, params = fp32_model()
    opt = training.make_optimizer(MESH_LR, 1000, use_scheduler=False)
    step = training.make_train_step(tcfg, opt, batch_size=64, num_negatives=64,
                                    device=DEVICE)
    host_batch = text_train_batch(
        TextGraphData.load(os.path.join(data_dir, "ind-train.tsv"),
                           tokenizer=WordPieceTokenizer(
                               os.path.join(data_dir, "vocab.txt")),
                           max_len=SEG, write_maps=True),
        next(epoch_batches(GraphData.load(os.path.join(data_dir, "ind-train.tsv")),
                           64, rng=np.random.default_rng(0))))
    batch = prefetch.to_device(host_batch, DEVICE)
    p1, _, loss = step(params, opt.init(params), (0, 0), batch)
    neg_seed, drop_seed = training.step_seeds((0, 0))
    _, grads = training.value_and_grad(
        params, tcfg, dict(batch, neg_idx=sampling.sample_negative_indices(
            torch.Generator(device=DEVICE).manual_seed(neg_seed), 64, 64, DEVICE)),
        dropout_seed=drop_seed)
    ref_path = os.path.join(WORK_DIR, "mesh_ref.pt")
    torch.save({"batch": {k: v.cpu() for k, v in batch.items()},
                "params": [x.cpu() for x in _leaves(training.restack_params(p1))],
                "grads": [x.cpu() for x in _leaves(training.restack_params(grads))],
                "loss": loss.item()}, ref_path)
    ref_loss = loss.item()
    del params, p1, step, grads
    torch.cuda.empty_cache()

    store = os.path.join(WORK_DIR, "mesh_store")
    out_path = os.path.join(WORK_DIR, "mesh_rank%d.pkl")
    ctx = torch.multiprocessing.start_processes(
        _mesh_rank, args=(n_ranks, rank_device, store, data_dir, ref_path,
                          out_path),
        nprocs=n_ranks, join=False, start_method="spawn")
    t0 = time.perf_counter()
    while not ctx.join(timeout=5):
        require(time.perf_counter() - t0 < 600, "the ranks ran past 600 s")
    ranks_s = time.perf_counter() - t0
    ranks = []
    for r in range(n_ranks):
        with open(out_path % r, "rb") as f:
            ranks.append(pickle.load(f))
    log(f"{n_ranks} ranks on {_placement(rank_device)}: {ranks_s:.1f} s for "
        f"the sharded passes and the three train steps, start-up included")

    # (b) the summed counts equal the one-process pass, bit for bit.
    table, rel, trip, fidx = _w5m_inputs(DEVICE)
    one, one_s = wall(lambda: w5m_counts(table, rel, trip, fidx))
    del table
    torch.cuda.empty_cache()
    for r in ranks:
        require(np.array_equal(r["w5m_counts"], one),
                "the sharded W5M counts differ from the one-process pass")
    by_variant = collections.Counter()
    for r in ranks:
        by_variant.update(r["launches"]["K1 by variant"])
    require(by_variant and all(v == "tma" for v, _ in by_variant),
            f"a sharded K1 launch did not take the tma variant: {by_variant}")
    w = [r["w5m"] for r in ranks]
    log(f"sharded rank pass at Wikidata5M scale ({W5M_ENTITIES:,} x {K1_D} "
        f"fp32 over {n_ranks} ranks, {w[0]['block_rows']:,} rows each, "
        f"{W5M_BATCHES} batches of 64, 64 filter columns): counts equal the "
        f"one-process pass bit for bit; per batch "
        f"{[round(x['ms_per_batch'], 2) for x in w]} ms wall, K1 "
        f"{[round(x['k1_ms_per_batch'], 3) for x in w]} ms device, collectives "
        f"{[round(x['collective_host_ms_per_batch'], 2) for x in w]} ms host, by "
        f"rank; one process {one_s * 1e3 / W5M_BATCHES:.2f} ms per batch; K1 "
        f"launches by variant {dict(by_variant)}")

    # (b) the sharded phase-1 encode: within the bf16 class of the
    # one-process table, and its MRR that of one process on the same table.
    tok = WordPieceTokenizer(os.path.join(data_dir, "vocab.txt"))
    train_d = TextGraphData.load(os.path.join(data_dir, "ind-train.tsv"),
                                 tokenizer=tok, max_len=SEG)
    test = GraphData.load(os.path.join(data_dir, "ind-test.tsv"))
    dev_g = GraphData.load(os.path.join(data_dir, "ind-dev.tsv"))
    entities = np.arange(len(train_d.ent_ids))
    fidx = FilterIndex(np.concatenate([train_d.triples, dev_g.triples, test.triples]))
    _, params = make_model(12)
    kw = dict(batch_size=64, filter_index=fidx, device=DEVICE)
    one_res = evaluation.eval_link_prediction(
        params, cfg, test.triples, train_d, entities, emb_batch_size=4096,
        return_embeddings=True, **kw)
    enc = ranks[0]["encode"]
    require(all(r["launches"]["K2"] > 0 for r in ranks),
            "a rank's share of the sharded encode launched no K2")
    diff = float(np.abs(enc["table"] - one_res.ent_emb).max())
    require(diff <= 1e-2, f"sharded encode differs from one process by {diff}")
    same = evaluation.eval_link_prediction(
        {"rel_emb": params["rel_emb"]}, cfg, test.triples, train_d, entities,
        ent_emb=enc["table"], **kw)
    require(all(r["encode"]["scalars"] == same.scalars("x") for r in ranks),
            "the sharded evaluation's metrics differ from one process on its table")
    del params
    torch.cuda.empty_cache()
    log(f"sharded phase-1 encode of {len(entities):,} entities with K2 on each "
        f"rank ({[r['launches']['K2'] for r in ranks]} K2 launches by rank): "
        f"max abs diff from the one-process table {diff:.3g} (limit 1e-2); "
        f"filtered MRR {enc['scalars']['x_mrr_filt']:.6f}, equal to one process "
        f"on the same table; {enc['s']:.2f} s for the sharded evaluation")

    # (c) each parallel step against the one-device step: the loss and the
    # gradients Adam is handed, at the CPU tests' tolerances. The parameters
    # after the step are reported: Adam's first step maps a gradient
    # difference d at |g| near eps = 1e-8 to lr d eps / (|g| + eps)^2, so
    # any other order of the sums moves a few near-zero-gradient elements by
    # up to lr (tests/test_torch_parallel.py).
    steps = {}
    for name in ("dp", "tp", "pp"):
        for r in ranks:
            st = r["steps"][name]
            require(abs(st["loss"] - ref_loss) <= LOSS_RTOL * abs(ref_loss),
                    f"{name}: loss {st['loss']} vs one device {ref_loss}")
            require(st["grad_excess"] <= 0, f"{name}: a gradient is beyond "
                    f"rtol {STEP_RTOL}, atol {STEP_ATOL} of one device's")
        st = ranks[0]["steps"][name]
        steps[name] = {"loss": st["loss"],
                       "ms": [r["steps"][name]["ms"] for r in ranks],
                       "param_max_abs": st["param_max_abs"],
                       "params_beyond": st["params_beyond"],
                       "grad_at_beyond": st["grad_at_beyond"]}
        log(f"{name} step (BERT-base fp32, B 64, L {SEG}, K3, {n_ranks} ranks "
            f"on {_placement(rank_device)}): loss {st['loss']:.6f} vs one device {ref_loss:.6f}; "
            f"gradients within rtol {STEP_RTOL}, atol {STEP_ATOL}; parameters "
            f"after the Adam step (lr {MESH_LR}) max abs diff "
            f"{st['param_max_abs']:.3g}, {st['params_beyond']} elements beyond "
            f"the tolerance, their one-device |g| at most "
            f"{st['grad_at_beyond']:.3g}; ms per step by rank "
            f"{[[round(t, 1) for t in ms] for ms in steps[name]['ms']]}")
    launches = collections.Counter()
    by_seg, f_by = collections.Counter(), collections.Counter()
    for r in ranks:
        launches.update({k: v for k, v in r["launches"].items()
                         if k not in BY_KEYS})
        by_seg.update(r["launches"]["K2 by seg"])
        f_by.update(r["launches"]["F by variant"])
    return ({"mesh_w5m": w, "mesh_w5m_one_ms": one_s * 1e3 / W5M_BATCHES,
             "mesh_encode_diff": diff, "mesh_steps": steps,
             "mesh_ref_loss": ref_loss, "mesh_ranks_s": ranks_s},
            {**launches, "K1 by variant": by_variant, "K2 by seg": by_seg,
             "F by variant": f_by})


# -- phase 10: the modules that complete the port --------------------------------

NATIVE_TRIPLES = 1_000_000        # the synthetic graph of (a)'s load times
NATIVE_ENTITIES, NATIVE_RELATIONS = 100_000, 200
PREFETCH_CHUNK = 1024             # phase-1 chunk of (c): 4 chunks of 4,096


@contextlib.contextmanager
def python_data_path():
    """The data layer's pure-Python parse and tokenize (the native packer
    reported unavailable), for the comparisons of (a)."""
    available = native.available
    native.available = lambda: False
    try:
        yield
    finally:
        native.available = available


@contextlib.contextmanager
def kernels_on():
    """The link_prediction command keeps the TPU package's defaults: XLA-style
    attention in its bf16 encodes and the plain scorer in its steps. Driven
    in-process here, the model config it builds gets K2
    (fused_attention=True) and K3 (sddmm_pallas=True)."""
    make = train.make_model_config

    def with_kernels(*args, **kw):
        mcfg = make(*args, **kw)
        enc = mcfg.encoder and dataclasses.replace(mcfg.encoder,
                                                   fused_attention=True)
        return dataclasses.replace(mcfg, encoder=enc, sddmm_pallas=True)

    train.make_model_config = with_kernels
    try:
        yield
    finally:
        train.make_model_config = make


def fresh_copy(data_dir: str, name: str) -> str:
    """The dataset's files without the token caches earlier phases wrote."""
    out = os.path.join(WORK_DIR, name)
    shutil.rmtree(out, ignore_errors=True)
    shutil.copytree(data_dir, out, ignore=shutil.ignore_patterns("text_*.npz"))
    return out


def write_native_graph(directory: str, seed: int = 0) -> str:
    """entities.txt, relations.txt and a train.tsv of NATIVE_TRIPLES random
    triples, from `seed`."""
    os.makedirs(directory, exist_ok=True)
    rng = np.random.default_rng(seed)
    ents = [f"/m/ent{i:06d}" for i in range(NATIVE_ENTITIES)]
    rels = [f"/rel/r{i:03d}" for i in range(NATIVE_RELATIONS)]
    for name, names in (("entities.txt", ents), ("relations.txt", rels)):
        with open(os.path.join(directory, name), "w") as f:
            f.write("\n".join(names) + "\n")
    h = rng.integers(0, NATIVE_ENTITIES, NATIVE_TRIPLES)
    t = rng.integers(0, NATIVE_ENTITIES, NATIVE_TRIPLES)
    r = rng.integers(0, NATIVE_RELATIONS, NATIVE_TRIPLES)
    with open(os.path.join(directory, "train.tsv"), "w") as f:
        f.write("".join(f"{ents[a]}\t{rels[c]}\t{ents[b]}\n"
                        for a, b, c in zip(h, t, r)))
    return directory


def native_packer(data_dir: str, build_s: float) -> dict:
    """(a): the native packer built on this host (in `build_s` seconds, in
    phase 2); its parse and tokenize of the synthetic graph equal the Python
    path's; both load times of a 1M-triple graph."""
    require(native.available(),
            f"the native packer did not build: {native.build_error}")
    calls = native.calls
    tok = WordPieceTokenizer(os.path.join(data_dir, "vocab.txt"))
    loaded = {}
    for path in ("native", "python"):
        d = fresh_copy(data_dir, f"native_{path}")
        with python_data_path() if path == "python" else contextlib.nullcontext():
            loaded[path] = [TextGraphData.load(os.path.join(d, "ind-train.tsv"),
                                               tokenizer=tok, max_len=SEG,
                                               write_maps=True)]
            loaded[path] += [GraphData.load(os.path.join(d, f"{s}.tsv"))
                             for s in ("train", "ind-dev", "ind-test")]
    require(native.calls - calls == 5,
            f"{native.calls - calls} native calls for 4 parses and 1 tokenize")
    for a, b in zip(loaded["native"], loaded["python"]):
        require(np.array_equal(a.triples, b.triples),
                "native and Python triple parses differ")
    require(np.array_equal(loaded["native"][0].text_data,
                           loaded["python"][0].text_data),
            "native and Python token matrices differ")
    big = write_native_graph(os.path.join(WORK_DIR, "native_1m"))
    times = {}
    for path in ("python", "native", "native", "python"):
        with python_data_path() if path == "python" else contextlib.nullcontext():
            t0 = time.perf_counter()
            g = GraphData.load(os.path.join(big, "train.tsv"), write_maps=True)
            times.setdefault(path, []).append(time.perf_counter() - t0)
        require(len(g.triples) == NATIVE_TRIPLES, f"{len(g.triples)} triples")
    shutil.rmtree(big, ignore_errors=True)
    log(f"native packer (ready after {build_s:.2f} s in phase 2): the "
        f"{len(loaded['native'][0].ent_ids):,}-entity graph's 4 triple files "
        f"and token matrix equal the Python path's; {NATIVE_TRIPLES:,}-triple "
        f"GraphData.load, host time of this machine: native "
        f"{[round(x, 3) for x in times['native']]} s, Python "
        f"{[round(x, 3) for x in times['python']]} s "
        f"({min(times['python']) / min(times['native']):.1f}x)")
    return {"native_build_s": build_s, "native_calls": native.calls - calls,
            "native_load_1m_s": times["native"],
            "python_load_1m_s": times["python"]}


def reference_bert_state_dict(vocab: int, num_relations: int,
                              seed: int = 0) -> dict:
    """A released dfdazac/blp BLP-TransE checkpoint's state dict, BERT-base
    (hidden 768, 12 layers, FFN 3072, 512 positions, dim 128), random from
    `seed`, with DataParallel's `module.` prefix (reference models.py)."""
    g = torch.Generator().manual_seed(seed)

    def w(*shape):
        return 0.02 * torch.randn(shape, generator=g)

    hidden, ffn = 768, 3072
    sd = {"rel_emb.weight": w(num_relations, 128),
          "enc_linear.weight": w(128, hidden),
          "encoder.embeddings.word_embeddings.weight": w(vocab, hidden),
          "encoder.embeddings.position_embeddings.weight": w(512, hidden),
          "encoder.embeddings.token_type_embeddings.weight": w(2, hidden),
          "encoder.embeddings.LayerNorm.weight": 1 + w(hidden),
          "encoder.embeddings.LayerNorm.bias": w(hidden),
          "encoder.pooler.dense.weight": w(hidden, hidden),
          "encoder.pooler.dense.bias": w(hidden)}
    for i in range(12):
        p = f"encoder.encoder.layer.{i}."
        for name in ("query", "key", "value"):
            sd[f"{p}attention.self.{name}.weight"] = w(hidden, hidden)
            sd[f"{p}attention.self.{name}.bias"] = w(hidden)
        sd[f"{p}attention.output.dense.weight"] = w(hidden, hidden)
        sd[f"{p}attention.output.dense.bias"] = w(hidden)
        sd[f"{p}attention.output.LayerNorm.weight"] = 1 + w(hidden)
        sd[f"{p}attention.output.LayerNorm.bias"] = w(hidden)
        sd[f"{p}intermediate.dense.weight"] = w(ffn, hidden)
        sd[f"{p}intermediate.dense.bias"] = w(ffn)
        sd[f"{p}output.dense.weight"] = w(hidden, ffn)
        sd[f"{p}output.dense.bias"] = w(hidden)
        sd[f"{p}output.LayerNorm.weight"] = 1 + w(hidden)
        sd[f"{p}output.LayerNorm.bias"] = w(hidden)
    return {f"module.{k}": v for k, v in sd.items()}


def cli_args(data_dir: str, out_dir: str, run_id: str) -> list[str]:
    return ["link_prediction", "with", f"data_dir={os.path.dirname(data_dir)}",
            f"dataset={os.path.basename(data_dir)}", f"out_dir={out_dir}",
            f"run_id={run_id}", "model=blp", "rel_model=transe", "bf16=True",
            "device=cuda", "emb_batch_size=4096"]


def run_cli(argv: list[str]) -> tuple[dict, float]:
    """`python -m blp_tpu_torch.train ...` in-process, with K2 and K3 on:
    (its result line, seconds)."""
    buf = io.StringIO()
    with kernels_on(), contextlib.redirect_stdout(buf):
        rc, s = wall(lambda: train.main(argv))
    require(rc == 0, f"{' '.join(argv[2:])} exited {rc}")
    return json.loads(buf.getvalue().strip().splitlines()[-1]), s


def released_checkpoint(data_dir: str, read_counts) -> dict:
    """(b): a reference-shaped BERT-base state dict through the port's
    converter, then `link_prediction max_epochs=0 checkpoint=`, whose test
    MRR must equal an in-process evaluation of the same parameters."""
    out_dir = os.path.join(WORK_DIR, "released")
    os.makedirs(out_dir, exist_ok=True)
    tok = WordPieceTokenizer(os.path.join(data_dir, "vocab.txt"))
    num_rels = len(GraphData.load(os.path.join(data_dir, "ind-train.tsv"),
                                  write_maps=True).rel_ids)
    pt, npz = os.path.join(out_dir, "model.pt"), os.path.join(out_dir, "model-blp.npz")
    torch.save(reference_bert_state_dict(len(tok.vocab), num_rels), pt)
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "blp_tpu_torch.tools.convert_reference_checkpoint",
         "--model", "blp", "--input", pt, "--output", npz],
        capture_output=True, text=True, timeout=300, cwd=ROOT)
    convert_s = time.perf_counter() - t0
    require(proc.returncode == 0, f"the converter exited {proc.returncode}: "
            f"{proc.stderr[-2000:]}")
    before = read_counts()
    res, cli_s = run_cli(cli_args(data_dir, out_dir, "released")
                         + ["max_epochs=0", f"checkpoint={npz}"])
    after = read_counts()
    k1, k2 = (after[k] - before[k] for k in ("K1", "K2"))

    # The same evaluation in-process: the command's test split, candidates,
    # filter and new-entity set.
    cfg = ExperimentConfig(data_dir=os.path.dirname(data_dir),
                           dataset=os.path.basename(data_dir), bf16=True)
    train_d = TextGraphData.load(os.path.join(data_dir, "ind-train.tsv"),
                                 tokenizer=tok, max_len=cfg.max_len)
    dev = GraphData.load(os.path.join(data_dir, "ind-dev.tsv"))
    test = GraphData.load(os.path.join(data_dir, "ind-test.tsv"))
    val_ents = np.unique(np.concatenate([train_d.entities, dev.entities]))
    all_ents = np.unique(np.concatenate([val_ents, test.entities]))
    with kernels_on():
        mcfg = train.make_model_config(cfg, tok, len(train_d.rel_ids),
                                       len(train_d.ent_ids))
    params, _ = ckpt.load_pytree(npz)
    ref = evaluation.eval_link_prediction(
        blp.to_device(params, "cuda"), mcfg, test.triples, train_d, all_ents,
        batch_size=cfg.eval_batch_size, emb_batch_size=4096, tile=cfg.tile,
        filter_index=FilterIndex(np.concatenate(
            [train_d.triples, dev.triples, test.triples])),
        new_entities=np.setdiff1d(all_ents, val_ents),
        rel_categories=train_d.rel_categories, device="cuda")
    require(res["test_mrr_filt"] == ref.mrr_filt and res["test_mrr"] == ref.mrr,
            f"link_prediction checkpoint= test MRR {res} != in-process "
            f"{ref.mrr} / {ref.mrr_filt}")
    require(k1 > 0 and k2 > 0, f"released-checkpoint evaluation launched K1 "
            f"{k1}, K2 {k2} times")
    log(f"released checkpoint (reference BERT-base BLP-TransE state dict, "
        f"{len(params['bert']['layers']['q_w'])} layers, `module.` prefix): "
        f"converted by `python -m blp_tpu_torch.tools.convert_reference_checkpoint` "
        f"in {convert_s:.1f} s; link_prediction max_epochs=0 checkpoint= "
        f"{cli_s:.1f} s, test MRR {res['test_mrr']:.6f} filtered "
        f"{res['test_mrr_filt']:.6f}, equal to the in-process evaluation; "
        f"K1 launched {k1} times, K2 {k2}")
    return {"released_convert_s": convert_s, "released_cli_s": cli_s,
            "released_test_mrr_filt": res["test_mrr_filt"],
            "released_k1": k1, "released_k2": k2}


def prefetched_encode(data_dir: str) -> dict:
    """(c): phase 1 of 4,096 entities through BERT-base bf16 with K2, from
    build_entity_table (prefetch thread) and from an in-line loop over the
    same chunks: bit-equal tables; entities/s of both; the device's busy
    share of the prefetched one."""
    cfg, params = make_model(num_relations=12)
    enc = blp.encode_view(params, cfg)
    data = TextGraphData.load(os.path.join(data_dir, "ind-train.tsv"),
                              tokenizer=WordPieceTokenizer(
                                  os.path.join(data_dir, "vocab.txt")),
                              max_len=SEG)
    ents = np.arange(len(data.ent_ids))
    n, chunk = len(ents), PREFETCH_CHUNK

    def encode_batch(tok, mask):
        return blp.encode(enc, cfg, tok, mask, device="cuda")

    def prefetched():
        return evaluation.build_entity_table(
            encode_batch, data, ents, emb_batch_size=chunk, dim=cfg.entity_dim,
            device="cuda", chunk_multiple=4)

    def inline():
        rows = []
        for start in range(0, n, chunk):
            ids = ents[start:start + chunk]
            tok, mask = data.get_entity_descriptions(ids)
            rows.append(encode_batch(tok, mask)[:len(ids)])
        table = torch.zeros((n, cfg.entity_dim), device="cuda")
        table[:n] = torch.cat(rows)
        return table

    require(n % chunk == 0, "the chunks of (c) must cover the entities evenly")
    times = {"inline": [], "prefetch": []}
    tables = {}
    for name in ("inline", "prefetch", "prefetch", "inline", "inline", "prefetch"):
        tables[name], s = wall(inline if name == "inline" else prefetched)
        times[name].append(s)
    require(torch.equal(tables["prefetch"], tables["inline"]),
            "the prefetched table differs from the in-line loop's")
    trace_dir = os.path.join(WORK_DIR, "trace_encode")
    with profiling.trace(trace_dir):
        _, traced_s = wall(prefetched)
    stats = profiling.summarize_trace_stats(trace_dir)
    busy = stats["total_device_time_us"] / 1e6 / traced_s
    rate = {k: n / min(v) for k, v in times.items()}
    log(f"phase-1 encode of {n:,} entities (BERT-base bf16, K2, chunks of "
        f"{chunk:,}): in line {[round(x * 1e3, 1) for x in times['inline']]} ms "
        f"= {rate['inline']:,.0f} entities/s at best; prefetched "
        f"{[round(x * 1e3, 1) for x in times['prefetch']]} ms = "
        f"{rate['prefetch']:,.0f} entities/s; tables bit-equal; traced "
        f"prefetched run: device busy {stats['total_device_time_us'] / 1e3:.2f} "
        f"of {traced_s * 1e3:.2f} ms wall ({100 * busy:.1f}%), by group "
        f"{ {k: round(v / 1e3, 2) for k, v in stats['by_category_us'].items()} } ms")
    return {"encode_inline_s": times["inline"], "encode_prefetch_s": times["prefetch"],
            "encode_inline_entities_per_s": rate["inline"],
            "encode_prefetch_entities_per_s": rate["prefetch"],
            "encode_prefetch_busy_share": busy}


def legacy_resume(read_counts) -> dict:
    """(d): a one-epoch BERT-base link_prediction run (B 64, L 32, K3) on a
    1,024-entity synthetic graph (a quarter of the flagship graph, to keep
    its three epochs short); marker-less stacked and unstacked copies of its
    state file load to the file's parameters and Adam moments bit for bit
    and resume at epoch 2, whose steps launch K3."""
    out_dir = os.path.join(WORK_DIR, "legacy")
    shutil.rmtree(out_dir, ignore_errors=True)
    data_dir = write_synth_dataset(os.path.join(WORK_DIR, "synth1024"),
                                   num_entities=1024, num_relations=12,
                                   num_triples=2000, seed=0)
    base = cli_args(data_dir, out_dir, "legacy") + ["batch_size=64",
                                                    f"max_len={SEG}"]
    _, first_s = run_cli(base + ["max_epochs=2", "stop_after_epochs=1"])
    state = os.path.join(out_dir, "train_state-legacy.npz")
    tree, meta = ckpt.load_pytree(state)
    require(meta.pop("layout") == "stacked", "the run wrote no layout marker")
    files = {"stacked": os.path.join(out_dir, "legacy-stacked.npz"),
             "unstacked": os.path.join(out_dir, "legacy-unstacked.npz")}
    ckpt.save_pytree(files["stacked"], tree, meta)
    ckpt.save_pytree(files["unstacked"], (training.unstack_params(tree[0]),
                                          training.unstack_opt_state(tree[1])), meta)
    want = _leaves(tree)
    tmpl = blp.to_device(tree[0], "meta")
    opt = training.make_optimizer(2e-5, 1)
    out = {"legacy_first_epoch_s": first_s}
    for name, path in files.items():
        (p, o), m = train.load_train_state(path, tmpl, opt)
        live = blp.to_device((training.unstack_params(p),
                              training.unstack_opt_state(o)), "cuda")
        got = _leaves((training.restack_params(live[0]),
                       training.restack_opt_state(live[1])))
        require(len(got) == len(want) and all(
            torch.equal(g.cpu(), w) for g, w in zip(got, want)),
            f"the {name} legacy file loaded to another state")
        require(int(m["epoch"]) + 1 == 2, f"{name}: start epoch {m['epoch'] + 1}")
        before = read_counts()
        res, s = run_cli(base + ["max_epochs=2", f"resume={path}",
                                 f"run_id=legacy-{name}"])
        k3 = read_counts()["K3"] - before["K3"]
        rows = [json.loads(line) for line in
                open(os.path.join(out_dir, f"metrics-legacy-{name}.jsonl"))]
        epochs = [r["step"] for r in rows if "train_loss" in r]
        require(epochs == [2] and k3 > 0 and math.isfinite(res["test_mrr_filt"]),
                f"{name} legacy resume: epochs {epochs}, K3 {k3}, {res}")
        log(f"legacy resume, marker-less {name} file: parameters and Adam "
            f"moments bit-equal to the file's on the card, start epoch 2; "
            f"epoch 2 and evals {s:.1f} s, K3 launched {k3} times, test MRR "
            f"filtered {res['test_mrr_filt']:.4f}")
        out[f"legacy_{name}_resume_s"] = s
        out[f"legacy_{name}_k3"] = k3
    return out


def profiling_check(data_dir: str, card: str) -> dict:
    """(e): StepTimer over 5 flagship steps; 3 of them traced, whose
    summarized device time must be within 2% of device_profile's busy time
    for the same 3 steps; device_memory_stats' peak against
    max_memory_allocated."""
    cfg, params = train_model(12)
    opt = training.make_optimizer(2e-5, 1000)
    state = opt.init(params)
    step = training.make_train_step(cfg, opt, batch_size=64, num_negatives=64,
                                    device="cuda")
    batches = train_batches(data_dir, SEG, 64, 5)
    torch.cuda.reset_peak_memory_stats()
    timer = profiling.StepTimer(sync_every=1)
    losses = []
    for i, batch in enumerate(batches):
        with timer.step():
            params, state, loss = step(params, state, (0, i), batch)
            losses.append(timer.sync(loss))
    require(all(math.isfinite(x) for x in losses), f"losses {losses}")

    def three():
        for i in range(3):
            step(params, state, (0, 5 + i), batches[i])

    trace_dir = os.path.join(WORK_DIR, "trace_steps")
    with profiling.trace(trace_dir):
        three()
    stats = profiling.summarize_trace_stats(trace_dir)
    prof = device_profile("3 flagship steps (as traced)", three)
    traced_ms = stats["total_device_time_us"] / 1e3
    rel = abs(traced_ms - prof["busy_ms"]) / prof["busy_ms"]
    require(rel <= 0.02, f"summarize_trace_stats {traced_ms:.3f} ms against "
            f"device_profile {prof['busy_ms']:.3f} ms of device time")
    mem = profiling.device_memory_stats()[0]
    peak = torch.cuda.max_memory_allocated()
    require(mem["allocated_bytes.all.peak"] == peak,
            f"device_memory_stats peak {mem['allocated_bytes.all.peak']} != "
            f"max_memory_allocated {peak}")
    summary = timer.summary()
    log(f"profiling: StepTimer over 5 flagship steps (synced each step): "
        f"{summary}; 3 steps traced: {traced_ms:.3f} ms device time by "
        f"summarize_trace_stats against {prof['busy_ms']:.3f} by device_profile "
        f"({100 * rel:.2f}% apart, limit 2%); top op "
        f"{stats['top_ops'][0]['name'][:60]} "
        f"{stats['top_ops'][0]['self_time_us'] / 1e3:.2f} ms; peak "
        f"{peak / 2**30:.2f} GiB from device_memory_stats equals "
        f"max_memory_allocated, on {card}")
    return {"step_timer": summary, "trace_device_ms": traced_ms,
            "profile_busy_ms": prof["busy_ms"], "trace_vs_profile": rel,
            "profiling_peak_bytes": peak}


def completion_phase(data_dir: str, card: str, read_counts,
                     native_build_s: float) -> dict:
    """Phase 10, (a)-(e); every count set to 0 just before it."""
    t0 = time.perf_counter()
    stats = native_packer(data_dir, native_build_s)
    stats.update(released_checkpoint(data_dir, read_counts))
    torch.cuda.empty_cache()
    stats.update(prefetched_encode(data_dir))
    torch.cuda.empty_cache()
    stats.update(legacy_resume(read_counts))
    torch.cuda.empty_cache()
    stats.update(profiling_check(data_dir, card))
    stats["phase10_s"] = time.perf_counter() - t0
    log(f"phase 10: {stats['phase10_s']:.1f} s")
    return stats


# -- phase 11: the Wikidata5M mode ----------------------------------------------

W5M_SCRIPT = os.path.join(ROOT, "scripts", "blp-transe-wikidata5m.sh")
# The graph of (a) and (b): 3% of its entities held out (as the rehearsal's
# graph), 822 relations (Wikidata5M's); 22 train steps of 1,024, valid and
# test splits of several hundred triples each.
W5M_GRAPH = dict(num_entities=20_000, num_relations=822, num_triples=24_000,
                 inductive_frac=0.03, seed=11)
W5M_E2E_N = 262_144              # candidates of (c)'s evaluation
W5M_SCALE_N = 1_000_000          # candidates of (c)'s streamed rank pass
FINAL_KEYS = ("valid_mrr", "valid_mrr_filt", "test_mrr", "test_mrr_filt")


def script_keys(path: str) -> list[str]:
    """The `key=value` words of a launcher's command, as the shell splits
    them."""
    import shlex

    text = open(path).read()
    words = shlex.split(text[text.index("python -m "):].replace("\\\n", " "))
    require(words[3:5] == ["link_prediction", "with"],
            f"{path} is not a link_prediction launcher")
    return words[5:]


@contextlib.contextmanager
def timed_evals(records: list):
    """Time each evaluation.eval_link_prediction call (the card synchronised
    before and after): (triples, candidates, filtered, seconds) each."""
    real = evaluation.eval_link_prediction

    def timed(params, cfg, triples, text, entities, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = real(params, cfg, triples, text, entities, **kw)
        torch.cuda.synchronize()
        records.append((len(triples), len(entities),
                        kw.get("filter_index") is not None,
                        time.perf_counter() - t0))
        return res

    evaluation.eval_link_prediction = timed
    try:
        yield
    finally:
        evaluation.eval_link_prediction = real


def _final_metrics(out_dir: str, run_id: str, max_epochs: int) -> dict:
    with open(os.path.join(out_dir, f"metrics-{run_id}.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    final = {k: v for r in rows if r["step"] == max_epochs + 1
             for k, v in r.items() if k in FINAL_KEYS}
    require(sorted(final) == sorted(FINAL_KEYS),
            f"run {run_id} logged no final evaluation: {sorted(final)}")
    require(not [k for r in rows for k in r if k.startswith("train_mrr")],
            f"run {run_id} ran the train-sample evaluation")
    return {"final": final, "rows": rows}


def _delta(before: dict, after: dict) -> dict:
    out = {k: after[k] - before[k] for k in ("K1", "K2", "K3", "K3 backward")}
    out["K2 by seg"] = dict(after["K2 by seg"] - before["K2 by seg"])
    return out


def _k2_chunks(n: int, emb_batch: int) -> int:
    """Phase-1 chunks build_entity_table encodes n entities in."""
    chunk = min(-(-emb_batch // 256) * 256, -(-max(n, 1) // 256) * 256)
    return -(-n // chunk)


def w5m_cli(read_counts) -> dict:
    """(a) one epoch of `link_prediction` with every key of
    scripts/blp-transe-wikidata5m.sh, and (b) its -pretrained keys on (a)'s
    model file, whose valid and test metrics must equal (a)'s final
    evaluation."""
    data_dir = write_synth_dataset(os.path.join(WORK_DIR, "w5m"), **W5M_GRAPH)
    out_dir = os.path.join(WORK_DIR, "w5m_run")
    keys = script_keys(W5M_SCRIPT)
    base = ["link_prediction", "with", *keys, f"data_dir={WORK_DIR}",
            "dataset=w5m", f"out_dir={out_dir}", "device=cuda"]
    cfg = parse_overrides(base[2:])
    require(cfg.large_dataset and cfg.max_len == W5M_SEG
            and cfg.batch_size == 1024 and cfg.emb_batch_size == 12288
            and cfg.remat == 8 and cfg.bf16, f"unexpected W5M keys {keys}")
    steps = GraphData.load(os.path.join(data_dir, "ind-train.tsv"),
                           write_maps=True).num_triples // cfg.batch_size
    require(steps >= 16, f"(a)'s epoch has {steps} steps, fewer than 16")

    evals: list = []
    before = read_counts()
    with timed_evals(evals):
        res, cli_s = run_cli(base + ["run_id=w5m", "max_epochs=1"])
    got = _delta(before, read_counts())
    a = _final_metrics(out_dir, "w5m", 1)
    tput = next(r["triples_per_sec"] for r in a["rows"] if "triples_per_sec" in r)
    step_s = cfg.batch_size / tput
    ents = [n for _, n, _, _ in evals]
    want_k1 = sum(-(-t // cfg.eval_batch_size) for t, _, _, _ in evals)
    want_k2 = 12 * sum(_k2_chunks(n, cfg.emb_batch_size) for n in ents)
    require(len(evals) == 3 and [f for _, _, f, _ in evals] == [False, True, True],
            f"(a) ran evaluations {evals}, not valid then filtered valid and test")
    require(got["K3"] == got["K3 backward"] == steps,
            f"(a) launched K3 {got['K3']} / {got['K3 backward']} times in {steps} steps")
    require(got["K2 by seg"] == {W5M_SEG: want_k2},
            f"(a) launched K2 {got['K2 by seg']} times, not {want_k2} at seg 64")
    require(got["K1"] == want_k1, f"(a) launched K1 {got['K1']} times, not "
            f"one a batch ({want_k1})")
    log(f"(a) link_prediction with the keys of {os.path.relpath(W5M_SCRIPT, ROOT)} "
        f"(BERT-base bf16, remat=8, max_len 64, B 1,024, K 64, lr 5e-5 with "
        f"warmup, emb_batch_size 12,288, large_dataset=True; max_epochs=1) on "
        f"a {W5M_GRAPH['num_entities']:,}-entity graph: {cli_s:.1f} s; "
        f"{steps} steps at {step_s * 1e3:.1f} ms a step ({tput:,.0f} triples/s); "
        f"evaluations (triples, candidates, filtered, s) "
        f"{[(t, n, f, round(x, 2)) for t, n, f, x in evals]}; final "
        f"{ {k: round(v, 6) for k, v in a['final'].items()} }; launches: K3 "
        f"{got['K3']} forward and {got['K3 backward']} backward (one a step), "
        f"K2 {got['K2 by seg']} by segment length (12 layers x "
        f"{want_k2 // 12} encodes), K1 {got['K1']} (one a batch of 64)")

    cache = [f for f in os.listdir(data_dir) if f.startswith("text_64_")]
    require(len(cache) == 1, f"(a) left text caches {cache}")
    cache_path = os.path.join(data_dir, cache[0])
    stamp = os.stat(cache_path).st_mtime_ns
    before = read_counts()
    res_b, cli_b = run_cli(base + ["run_id=w5m-pretrained", "max_epochs=0",
                                   f"checkpoint={res['checkpoint']}",
                                   "use_cached_text=True"])
    got_b = _delta(before, read_counts())
    b = _final_metrics(out_dir, "w5m-pretrained", 0)
    require(b["final"] == a["final"], f"(b)'s metrics {b['final']} differ from "
            f"(a)'s final evaluation {a['final']}")
    require(os.stat(cache_path).st_mtime_ns == stamp, "(b) rewrote the text cache")
    log(f"(b) the -pretrained keys (max_epochs=0 checkpoint=<(a)'s model file> "
        f"use_cached_text=True): {cli_b:.1f} s; valid and test MRR equal to "
        f"(a)'s final evaluation; the text cache {cache[0]} read, not rewritten; "
        f"launches {got_b}")
    return {"w5m_cli_s": cli_s, "w5m_step_ms": step_s * 1e3, "w5m_steps": steps,
            "w5m_eval_s": [x for *_, x in evals], "w5m_final": a["final"],
            "w5m_pretrained_s": cli_b, "w5m_launches": got,
            "w5m_pretrained_launches": got_b}


def _quiet(fn, argv):
    """fn(argv) with its standard output dropped (a tool's printed lines)."""
    with contextlib.redirect_stdout(io.StringIO()):
        return fn(argv)


def w5m_tools(read_counts) -> dict:
    """(c) the ported w5m_e2e_eval at 262,144 candidates (BERT-base bf16,
    K2 at seg 64 in 6,144-row chunks) and w5m_scale_check at 1M; (d) the
    ported umls_smoke."""
    from blp_tpu_torch.tools import umls_smoke, w5m_e2e_eval, w5m_scale_check

    before = read_counts()
    e2e = _quiet(w5m_e2e_eval.main, ["--n", str(W5M_E2E_N), "--max-len", "64",
                                     "--emb-batch", "12288"])
    got = _delta(before, read_counts())
    want_k2 = 12 * _k2_chunks(W5M_E2E_N, 12288)
    require(got["K2 by seg"] == {W5M_SEG: want_k2},
            f"(c) launched K2 {got['K2 by seg']} times, not {want_k2} at seg 64")
    require(got["K1"] == -(-e2e["n_triples"] // 64), f"(c) launched K1 {got['K1']} times")
    require(0 < e2e["mrr_filt"] < 1, f"(c) mrr_filt {e2e['mrr_filt']}")
    log(f"(c) w5m_e2e_eval --n {W5M_E2E_N:,} --max-len 64 --emb-batch 12288 "
        f"(K2 on the card): encode {e2e['encode_seconds']} s "
        f"({e2e['entities_per_s']:,.0f} entities/s), rank "
        f"{e2e['rank_seconds']} s for {e2e['n_triples']:,} triples, mrr_filt "
        f"{e2e['mrr_filt']:.6f}, peak {e2e.get('peak_mem_gib')} GiB; launches {got}")
    torch.cuda.empty_cache()
    scale = _quiet(w5m_scale_check.main, ["--n", str(W5M_SCALE_N)])
    log(f"(c) w5m_scale_check --n {W5M_SCALE_N:,}: rank pass "
        f"{scale['rank_pass_s']} s ({scale['cand_scores_per_sec']} M scores/s, "
        f"B {scale['batch']}, tile {scale['tile']}), peak {scale.get('peak_mem_gib')} "
        f"GiB (table {scale['table_gb']} GiB)")
    torch.cuda.empty_cache()

    before = read_counts()
    umls = _quiet(umls_smoke.main, ["--out", os.path.join(WORK_DIR, "umls")])
    got_u = _delta(before, read_counts())
    require(0 < umls["test_mrr_filt"] < 1 and got_u["K1"] > 0,
            f"(d) UMLS smoke {umls}, launches {got_u}")
    log(f"(d) umls_smoke (bert-bow, TransE, 5 epochs, 135 entities): "
        f"{umls['value']} s wall against the reference's claim of < 60 s on "
        f"an unspecified GPU; test MRR filtered {umls['test_mrr_filt']:.6f}; "
        f"launches {got_u}")
    return {"w5m_e2e": e2e, "w5m_e2e_launches": got, "w5m_scale": scale,
            "umls_s": umls["value"], "umls_test_mrr_filt": umls["test_mrr_filt"]}


def w5m_phase(read_counts) -> dict:
    """Phase 11, (a)-(d); every count set to 0 just before it."""
    t0 = time.perf_counter()
    stats = w5m_cli(read_counts)
    torch.cuda.empty_cache()
    stats.update(w5m_tools(read_counts))
    torch.cuda.empty_cache()
    stats["phase11_s"] = time.perf_counter() - t0
    log(f"phase 11: {stats['phase11_s']:.1f} s")
    return stats


# -- phase 12: the measurement entry points ----------------------------------

SERVE_N = 1_000_000               # candidates of (b), the tool's default
BENCH_WINDOWS = 2                 # (d): windows of 20 flagship steps
FAMILY_REPS = 2                   # (e): steps a window


def bench_tools(read_counts) -> dict:
    """(a) rank_bench at its default (4.8M x 128, B 64); (b) serving_bench at
    1M candidates and its answers' ids and scores; (c)
    measure_reference_baseline into WORK_DIR; (d) the flagship bench step
    through bench.measure, against (c)'s file; (e) family_bench for every
    family."""
    from blp_tpu_torch import bench
    from blp_tpu_torch.tools import (family_bench, measure_reference_baseline,
                                     rank_bench, serving_bench)

    before = read_counts()
    rank = _quiet(rank_bench.main, [])
    got = _delta(before, read_counts())
    require(rank["beyond_rounding_band"] == 0 and got["K1"] == 6,
            f"(a) rank_bench: {rank}, launches {got}")
    log(f"(a) rank_bench (N {rank['n']:,}, B {rank['b']}, d {rank['d']}): plain "
        f"stream {rank['plain_ms']} ms, K1 {rank['k1_ms']} ms a both-direction "
        f"call ({rank['speedup']}x); {rank['mismatches']} of {8 * rank['b']} "
        f"count entries more than 1 apart, largest difference "
        f"{rank['max_count_diff']}, none beyond the fp32 rounding band of the "
        f"pivot; peak {rank['peak_mem_gib']} GiB; launches {got}")
    torch.cuda.empty_cache()

    rows = _quiet(serving_bench.main, ["--n", str(SERVE_N)])
    args = serving_bench.parse_args(["--n", str(SERVE_N)])
    srv = serving_bench.make_server(args, None, DEVICE)
    table, queries = serving_bench.draw_inputs(args.n, args.d, args.batches)
    srv.set_candidates(table, np.arange(args.n))
    for b, emb, rels in queries:
        scores, ids = srv.predict_tails(head_emb=emb, rels=rels, k=args.k)
        require(ids.shape == (b, args.k) and bool(((ids >= 0) & (ids < args.n)).all())
                and bool(np.isfinite(scores).all())
                and bool((np.diff(scores, axis=1) <= 0).all()),
                f"(b) batch {b}: ids {ids[:1]}, scores {scores[:1]}")
    del srv, table
    log(f"(b) serving_bench --n {SERVE_N:,} (valid ids, finite sorted scores): "
        + "; ".join(f"batch {r['batch']} p50 {r['p50']} ms p95 {r['p95']} ms "
                    f"{r['qps']} q/s" for r in rows))
    torch.cuda.empty_cache()

    path = os.path.join(WORK_DIR, "bench_baseline_torch.json")
    base = _quiet(measure_reference_baseline.main, ["--out", path])
    log(f"(c) measure_reference_baseline: {base['value']:.2f} triples/s "
        f"({base['sec_per_step'] * 1e3:.1f} ms a step, B 16, L 32, K 16, fp32) "
        f"on {base['hardware']}; peak {base['peak_mem_gib']} GiB")
    torch.cuda.empty_cache()

    (B, L, K), (steps, warmup, _) = bench.FLAGSHIP["shape"], bench.FLAGSHIP["timing"]
    times = bench.measure(B, L, K, steps, warmup, BENCH_WINDOWS,
                          bench.model_config(bench.FLAGSHIP), DEVICE)
    flag = bench.report(B, times, w5m=False, baseline=path)
    require(flag["vs_baseline"] > 0, f"(d) bench: {flag}")
    log(f"(d) bench flagship (B {B}, L {L}, K {K}): windows "
        f"{[round(t * 1e3, 1) for t in times]} ms a step, {flag['value']} "
        f"triples/s, vs_baseline {flag['vs_baseline']}")
    torch.cuda.empty_cache()

    family = []
    for model in family_bench.FAMILIES:
        row = family_bench.bench_family(model, reps=FAMILY_REPS)
        require(0 < row["triples_per_sec"] < float("inf"), f"(e) {row}")
        family.append(row)
        torch.cuda.empty_cache()
    log("(e) family_bench --reps 2: " + "; ".join(
        f"{r['model']} B {r['batch']} {r['ms_per_step']} ms "
        f"{r['triples_per_sec']:,.0f} t/s peak {r['peak_mem_gib']} GiB"
        for r in family))
    return {"rank_bench": rank, "rank_bench_launches": got, "serving": rows,
            "reference_baseline": base, "bench_flagship": {**flag, "windows_s": times},
            "family": family}


def scaling_cli(n_ranks: int = RANKS, rank_device: str = RANK_DEVICE) -> dict:
    """(f) scaling_bench under torch.distributed.run, n_ranks gloo ranks on
    rank_device."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           f"--nproc-per-node={n_ranks}", "-m", "blp_tpu_torch.tools.scaling_bench",
           "--device", rank_device]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600,
                          cwd=ROOT)
    run_s = time.perf_counter() - t0
    require(proc.returncode == 0, f"scaling_bench exited {proc.returncode}: "
            f"{proc.stderr[-3000:]}")
    rows = [json.loads(ln) for ln in proc.stdout.splitlines() if ln.startswith("{")]
    require([(r["bench"], r["mesh"]) for r in rows] == [
        ("train", [1, 1]), ("train", [n_ranks, 1]),
        ("eval_rank", [1, 1]), ("eval_rank", [n_ranks, 1])]
        and all("virtual_mesh_overhead_vs_1dev" in r for r in rows),
        f"scaling_bench rows {rows}")
    log(f"(f) scaling_bench, {n_ranks} ranks on {_placement(rank_device)} "
        f"({run_s:.1f} s, launcher included): " + "; ".join(
            f"{r['bench']} {r['mesh']} "
            f"{r.get('edges_per_sec', r.get('cand_scores_per_sec')):,.1f}/s "
            f"(x{r['virtual_mesh_overhead_vs_1dev']})" for r in rows))
    return {"scaling_rows": rows, "scaling_s": run_s}


def bench_phase(read_counts) -> dict:
    """Phase 12, (a)-(f); every count set to 0 just before it."""
    t0 = time.perf_counter()
    stats = bench_tools(read_counts)
    torch.cuda.empty_cache()
    stats.update(scaling_cli())
    stats["phase12_s"] = time.perf_counter() - t0
    log(f"phase 12: {stats['phase12_s']:.1f} s")
    return stats


# -- phase 13: the layer's fused chains (F1, F2) ---------------------------------

W5M_TOKENS = 131_072              # the W5M train step: 2,048 descriptions x L 64
ENCODE_CHUNK = 12_288             # the W5M scripts' emb_batch_size
ENCODE_TOKENS = ENCODE_CHUNK * 64  # one phase-1 chunk at L 64
F_CHECK_ROWS = 16_384             # rows of the f32 variants' checks
F_BLOCK_ROWS = 16_384             # rows of one block of the plain references
BERT_H, BERT_I = 768, 3072
# The same peaks before F1 and F2 (PERF.md §5).
W5M_PEAK_GIB_BEFORE, CHUNK_PEAK_GIB_BEFORE = 30.85, 72.01
F_DT = {"bf16": torch.bfloat16, "f32": torch.float32}
#: F1's checks: (act, h dtype, out dtype, rows, width, backward). The main
#: path's variants: none at 768 (q, k, v, attn_out, ffn_out) and erf or poly
#: at 3072 (ffn_in) at the W5M train step's and the encode chunk's rows; f32
#: h under tensor parallelism, f32 out with mixed_precision_train off, f32
#: throughout in fp32 mode.
F1_CASES = (("none", "bf16", "bf16", W5M_TOKENS, BERT_H, True),
            ("erf", "bf16", "bf16", W5M_TOKENS, BERT_I, True),
            ("poly", "bf16", "bf16", W5M_TOKENS, BERT_I, True),
            ("none", "bf16", "bf16", ENCODE_TOKENS, BERT_H, False),
            ("poly", "bf16", "bf16", ENCODE_TOKENS, BERT_I, False),
            ("none", "f32", "bf16", F_CHECK_ROWS, BERT_H, True),
            ("none", "bf16", "f32", F_CHECK_ROWS, BERT_H, True),
            ("none", "f32", "f32", F_CHECK_ROWS, BERT_H, True),
            ("erf", "f32", "f32", F_CHECK_ROWS, BERT_I, True),
            ("poly", "f32", "f32", F_CHECK_ROWS, BERT_I, True))
#: F1's head-major checks (q, k and v): (packed rows B, S, cotangent,
#: backward): the W5M train step's 1,024 rows of 128 (12 heads of 64) with
#: q's cotangent (contiguous) and k's ((B, nh, hd, S) in memory, as q k^T's
#: backward leaves it), and the encode chunk's 6,144 rows, forward.
F1_HEAD_CASES = ((W5M_TOKENS // 128, 128, "q", True), (W5M_TOKENS // 128, 128, "k", True),
                 (ENCODE_TOKENS // 128, 128, None, False))
F1_HEAD_DIM = 64
#: F2's checks: (with r, x dtype, out dtype, rows, backward): the layers'
#: residual LayerNorms and the embedding LayerNorm (f32 sum, no r).
F2_CASES = ((True, "bf16", "bf16", W5M_TOKENS, True),
            (False, "f32", "bf16", W5M_TOKENS, True),
            (True, "bf16", "bf16", ENCODE_TOKENS, False),
            (True, "f32", "f32", F_CHECK_ROWS, True),
            (False, "f32", "f32", F_CHECK_ROWS, True))


def within_ulp(got, want, atol: float = 0.0, ulps: int = 1) -> bool:
    """Every element of bf16 `got` within `ulps` bf16 ulps of `want` (plus
    atol)."""
    w = want.float()
    ulp = torch.ldexp(torch.ones_like(w), torch.frexp(w).exponent - 8)
    return bool(((got.float() - w).abs() <= ulps * ulp + atol).all())


def f_close(got, want, *, rows_summed: bool = False,
            ulps: int = 1) -> tuple[bool, float]:
    """(within tolerance, max abs err). bf16: `ulps` bf16 ulps (one, or two
    for F3's output after the dropout's second rounding); f32: rtol 1e-5,
    atol 1e-5 x max|want|. rows_summed (F2's and F3's outputs): plus 1e-5 x
    max|want| for the f32 order of the row sums behind them."""
    err = (got.float() - want.float()).abs().max().item() if got.numel() else 0.0
    top = want.float().abs().max().item() if want.numel() else 0.0
    if got.dtype == torch.bfloat16:
        return within_ulp(got, want, 1e-5 * top if rows_summed else 0.0, ulps), err
    return torch.allclose(got, want, rtol=1e-5, atol=1e-5 * top), err


def sum_close(got, want) -> tuple[bool, float]:
    """An f32 sum over rows (db, dscale, dbias): rtol 1e-4, atol 1e-4 x
    max|want| (another order over up to 786,432 rows)."""
    top = want.abs().max().item()
    return (torch.allclose(got, want, rtol=1e-4, atol=1e-4 * top),
            (got - want).abs().max().item())


def f1_inputs(rows: int, w: int, h_dt, out_dt, seed: int):
    """h (its range reaches past poly's clamp at +-4), f32 b, cotangent."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    h = (2.5 * torch.randn((rows, w), generator=g, device="cuda")).to(h_dt)
    b = 0.5 * torch.randn(w, generator=g, device="cuda")
    gy = torch.randn((rows, w), generator=g, device="cuda").to(out_dt)
    return h, b, gy


def f2_inputs(rows: int, with_r: bool, x_dt, out_dt, seed: int):
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = (1.0 + torch.randn((rows, BERT_H), generator=g, device="cuda")).to(x_dt)
    r = (0.5 * torch.randn((rows, BERT_H), generator=g, device="cuda")).to(x_dt)
    scale = 1.0 + 0.1 * torch.randn(BERT_H, generator=g, device="cuda")
    bias = 0.1 * torch.randn(BERT_H, generator=g, device="cuda")
    gy = torch.randn((rows, BERT_H), generator=g, device="cuda").to(out_dt)
    return x, (r if with_r else None), scale, bias, gy


def _plain_blocks(fn, args_rows, args_fixed, gy, backward: bool):
    """The plain version run over row blocks of F_BLOCK_ROWS (its autograd
    graph at the full shape would hold tens of GB): the output, the
    gradients of the row inputs, and those of the fixed inputs summed over
    the blocks."""
    ys, d_rows, d_fixed = [], [], None
    rows = args_rows[0].shape[0]
    for i in range(0, rows, F_BLOCK_ROWS):
        part = [a[i:i + F_BLOCK_ROWS].detach().requires_grad_(backward)
                for a in args_rows]
        fixed = [a.detach().requires_grad_(backward) for a in args_fixed]
        with torch.set_grad_enabled(backward):
            y = fn(*part, *fixed)
        if backward:
            got = torch.autograd.grad(y, part + fixed, gy[i:i + F_BLOCK_ROWS])
            d_rows.append(got[:len(part)])
            dfx = got[len(part):]
            d_fixed = dfx if d_fixed is None else [a + b for a, b in zip(d_fixed, dfx)]
        ys.append(y.detach())
    cat = [torch.cat(d) for d in zip(*d_rows)] if backward else None
    return torch.cat(ys), cat, d_fixed


def check_f1() -> dict:
    """(a), F1: each case's output, dh and db against the plain version;
    dh and db identical across two backward calls."""
    errs = {}
    for i, (act, hd, od, rows, w, backward) in enumerate(F1_CASES):
        h, b, gy = f1_inputs(rows, w, F_DT[hd], F_DT[od], seed=30 + i)
        plain = lambda hh, bb: fused_layer.bias_act_plain(hh, bb, act, F_DT[od])  # noqa: E731,B023
        want, d_want, db_want = _plain_blocks(plain, [h], [b], gy, backward)
        hh = h.detach().requires_grad_(backward)
        bb = b.detach().requires_grad_(backward)
        with torch.set_grad_enabled(backward):
            got = fused_layer.bias_act(hh, bb, act, F_DT[od])
        ok, err = f_close(got, want)
        what = f"F1 {act} {hd}->{od} at {rows:,} x {w}"
        require(ok, f"{what}: y differs from the plain version (max abs err {err})")
        rec = {"y": err}
        del want
        if backward:
            calls = [torch.autograd.grad(got, (hh, bb), gy, retain_graph=True)
                     for _ in range(2)]
            (dh, db), (dh2, db2) = calls
            require(torch.equal(dh, dh2) and torch.equal(db, db2),
                    f"{what}: dh or db differ between two backward calls")
            ok, rec["dh"] = f_close(dh, d_want[0])
            require(ok, f"{what}: dh differs (max abs err {rec['dh']})")
            ok, rec["db"] = sum_close(db, db_want[0])
            require(ok, f"{what}: db differs (max abs err {rec['db']})")
            rec["dh_equal"] = bool(torch.equal(dh, d_want[0]))
            del calls, dh, db, dh2, db2, d_want
        log(f"F1 check {what}: " + ", ".join(f"{k} {v:.3g}" if isinstance(v, float)
                                             else f"{k} {v}" for k, v in rec.items()))
        errs[what] = rec
        del h, b, gy, got, hh, bb
        torch.cuda.empty_cache()
    return errs


def f1_head_cotangent(B: int, S: int, which: str, seed: int):
    """A bf16 cotangent of a head-major (B, 12, S, 64) q ("q": contiguous)
    or k ("k": held as (B, 12, 64, S), as q k^T's backward leaves it)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    nh = BERT_H // F1_HEAD_DIM
    if which == "k":
        return torch.randn((B, nh, F1_HEAD_DIM, S), generator=g, device="cuda").to(
            torch.bfloat16).transpose(-1, -2)
    return torch.randn((B, nh, S, F1_HEAD_DIM), generator=g,
                       device="cuda").to(torch.bfloat16)


def check_f1_heads() -> dict:
    """(a), F1 head-major (the q, k and v projections): y (B, 12, S, 64)
    bit-equal to the plain version; dh bit-equal to the cotangent's rows,
    db within sum_close of their f32 column sum, both identical across two
    backward calls."""
    errs, bf = {}, torch.bfloat16
    for i, (B, S, which, backward) in enumerate(F1_HEAD_CASES):
        g = torch.Generator(device="cuda").manual_seed(60 + i)
        h = torch.randn((B, S, BERT_H), generator=g, device="cuda").to(bf)
        b = torch.randn(BERT_H, generator=g, device="cuda")
        hh, bb = h.detach().requires_grad_(backward), b.detach().requires_grad_(backward)
        with torch.set_grad_enabled(backward):
            got = fused_layer.bias_act(hh, bb, "none", bf, head_dim=F1_HEAD_DIM)
        want = fused_layer.bias_act_plain(h, b, "none", bf, head_dim=F1_HEAD_DIM)
        what = f"F1 none head-major at {B:,} x {S} x {BERT_H}" + (
            f", {which}'s cotangent" if backward else "")
        require(got.is_contiguous() and torch.equal(got, want),
                f"{what}: y differs from the plain version")
        rec = {"y_equal": True}
        del want
        if backward:
            gy = f1_head_cotangent(B, S, which, seed=65 + i)
            (dh, db), (dh2, db2) = [torch.autograd.grad(got, (hh, bb), gy,
                                                        retain_graph=True)
                                    for _ in range(2)]
            require(torch.equal(dh, dh2) and torch.equal(db, db2),
                    f"{what}: dh or db differ between two backward calls")
            rows = fused_layer.from_heads(gy)
            ok, rec["db"] = sum_close(db, rows.float().sum((0, 1)))
            require(torch.equal(dh, rows) and ok,
                    f"{what}: dh is not g's rows, or db differs ({rec['db']})")
            rec["dh_equal"] = True
            del dh, db, dh2, db2, gy, rows
        log(f"F1 check {what}: " + ", ".join(f"{k} {v}" for k, v in rec.items()))
        errs[what] = rec
        del h, b, hh, bb, got
        torch.cuda.empty_cache()
    return errs


def check_f2() -> dict:
    """(a), F2: each case's output, ds, dscale and dbias against the plain
    version; identical across two backward calls."""
    errs = {}
    eps = bert.BertConfig().layer_norm_eps
    for i, (with_r, xd, od, rows, backward) in enumerate(F2_CASES):
        x, r, scale, bias, gy = f2_inputs(rows, with_r, F_DT[xd], F_DT[od], 40 + i)
        if with_r:
            plain = lambda xx, rr, sc, bi: fused_layer.add_layer_norm_plain(  # noqa: E731,B023
                xx, rr, sc, bi, eps, F_DT[od])
            want, d_rows, d_fixed = _plain_blocks(plain, [x, r], [scale, bias], gy,
                                                  backward)
        else:
            plain = lambda xx, sc, bi: fused_layer.add_layer_norm_plain(  # noqa: E731,B023
                xx, None, sc, bi, eps, F_DT[od])
            want, d_rows, d_fixed = _plain_blocks(plain, [x], [scale, bias], gy,
                                                  backward)
        ins = [t.detach().requires_grad_(backward) for t in (x, r, scale, bias)
               if t is not None]
        with torch.set_grad_enabled(backward):
            got = fused_layer.add_layer_norm(ins[0], ins[1] if with_r else None,
                                             ins[-2], ins[-1], eps, F_DT[od])
        ok, err = f_close(got, want, rows_summed=True)
        what = f"F2 {'x+r' if with_r else 'x'} {xd}->{od} at {rows:,} x {BERT_H}"
        require(ok, f"{what}: y differs from the plain version (max abs err {err})")
        rec = {"y": err, "y_over_1ulp": over_one_ulp(got, want)
               if got.dtype == torch.bfloat16 else 0.0}
        del want
        if backward:
            calls = [torch.autograd.grad(got, ins, gy, retain_graph=True)
                     for _ in range(2)]
            require(all(torch.equal(a, b) for a, b in zip(*calls)),
                    f"{what}: gradients differ between two backward calls")
            grads = calls[0]
            if with_r:
                require(torch.equal(grads[0], grads[1]), f"{what}: dx != dr")
            ok, rec["ds"] = f_close(grads[0], d_rows[0], rows_summed=True)
            require(ok, f"{what}: ds differs (max abs err {rec['ds']})")
            rec["ds_over_1ulp"] = (over_one_ulp(grads[0], d_rows[0])
                                   if grads[0].dtype == torch.bfloat16 else 0.0)
            for name, got_d, want_d in zip(("dscale", "dbias"), grads[-2:], d_fixed):
                ok, rec[name] = sum_close(got_d, want_d)
                require(ok, f"{what}: {name} differs (max abs err {rec[name]})")
            del calls, grads, d_rows, d_fixed
        log(f"F2 check {what}: " + ", ".join(f"{k} {v:.3g}" for k, v in rec.items()))
        errs[what] = rec
        del x, r, scale, bias, gy, got, ins
        torch.cuda.empty_cache()
    return errs


def w5m_point() -> dict:
    """(b): the TPU bench's W5M point (B 1,024, L 64, K 64, remat=4,
    fast_train, 8-bit masks) through bench.measure, BENCH_WINDOWS windows."""
    from blp_tpu_torch import bench

    (B, L, K), (steps, warmup, _) = bench.W5M["shape"], bench.W5M["timing"]
    torch.cuda.reset_peak_memory_stats()
    times = bench.measure(B, L, K, steps, warmup, BENCH_WINDOWS,
                          bench.model_config(bench.W5M), DEVICE)
    peak = torch.cuda.max_memory_allocated()
    rep = bench.report(B, times, w5m=True)
    require(rep["value"] > 0 and peak < 80e9, f"(b) W5M point: {rep}, peak {peak}")
    log(f"(b) bench --w5m point (B {B}, L {L}, K {K}, remat=4, fast_train, 8-bit "
        f"masks): windows {[round(t * 1e3, 1) for t in times]} ms a step, "
        f"{rep['value']} triples/s, peak {peak / 2**30:.2f} GiB "
        f"(max_memory_allocated; out of memory at 78.06 GiB before F1 and F2)")
    return {"w5m_point_s": times, "w5m_point_triples_per_s": rep["value"],
            "w5m_point_peak_bytes": peak}


def encode_chunk() -> dict:
    """(d): one phase-1 chunk of the W5M scripts' keys, 12,288 entities at L
    64 through BERT-base bf16 with K2: peak memory and entities/s."""
    cfg, params = make_model(num_relations=12)
    rng = np.random.default_rng(13)
    ids = torch.from_numpy(rng.integers(1, BERT_VOCAB, (ENCODE_CHUNK, 64))).cuda()
    lens = torch.from_numpy(rng.integers(8, 65, ENCODE_CHUNK)).cuda()
    mask = (torch.arange(64, device="cuda")[None] < lens[:, None]).float()
    view = blp.encode_view(params, cfg)
    blp.encode(view, cfg, ids, mask, device=DEVICE)          # warm-up
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    out, s = wall(lambda: blp.encode(view, cfg, ids, mask, device=DEVICE))
    peak = torch.cuda.max_memory_allocated()
    require(out.shape == (ENCODE_CHUNK, 128) and bool(torch.isfinite(out).all()),
            f"(d) encode chunk: {tuple(out.shape)}")
    log(f"(d) phase-1 chunk of {ENCODE_CHUNK:,} entities at L 64 (BERT-base "
        f"bf16, K2 at seg 64): {s * 1e3:.1f} ms, {ENCODE_CHUNK / s:,.0f} "
        f"entities/s, peak {peak / 2**30:.2f} GiB (before F1 and F2: "
        f"{CHUNK_PEAK_GIB_BEFORE} GiB)")
    del params, view, out
    return {"encode_chunk_s": s, "encode_chunk_entities_per_s": ENCODE_CHUNK / s,
            "encode_chunk_peak_bytes": peak}


def fused_phase(w5m_remat8_peak: int) -> tuple[dict, dict]:
    """Phase 13: (a) F1 and F2 against their plain versions (not counted);
    then, with every count set to 0, (b) the W5M point, (c) phase 6's
    remat=8 peak beside its figure before, (d) the encode chunk. Returns the
    stats and the launches of (b) and (d)."""
    t0 = time.perf_counter()
    stats = {"f1_check": check_f1(), "f1_heads_check": check_f1_heads(),
             "f2_check": check_f2()}
    torch.cuda.empty_cache()
    reset_counts()
    stats.update(w5m_point())
    torch.cuda.empty_cache()
    log(f"(c) W5M train step at remat=8 (phase 6 (c)): peak "
        f"{w5m_remat8_peak / 2**30:.2f} GiB (before F1 and F2: "
        f"{W5M_PEAK_GIB_BEFORE} GiB)")
    stats.update(encode_chunk())
    launches = read_counts()
    torch.cuda.empty_cache()
    stats["phase13_s"] = time.perf_counter() - t0
    log(f"phase 13: {stats['phase13_s']:.1f} s")
    return stats, launches


# -- phase 14: the attention softmax chain (F3) ---------------------------------

ATTN_HEADS, ATTN_SP, ATTN_HD = 12, 128, 64   # BERT-base heads, packed row, head dim
F3_SMALL_ROWS = 64                # rows of the other variants' checks
#: F3's checks: (l dtype, out dtype, round_logits, dropout bits, packed
#: rows, segment length (None: the unpacked (B, 1, 1, S) bias), backward).
#: The main path's: the training variant with 8-bit (bench --w5m) and
#: 32-bit (phase 6) masks at the W5M train step's 1,024 rows of two 64-token
#: segments; the inference variant at the W5M encode chunk (6,144 rows) and
#: at L 32 (1,024 rows of four segments); bf16 -> f32 with
#: mixed_precision_train off, f32 in fp32 mode, no dropout, and an unpacked
#: bias at a small shape.
F3_CASES = (("bf16", "bf16", False, 8, 1024, W5M_SEG, True),
            ("bf16", "bf16", False, 32, 1024, W5M_SEG, True),
            ("bf16", "bf16", True, None, W5M_K2_ROWS, W5M_SEG, False),
            ("bf16", "bf16", True, None, 1024, SEG, False),
            ("bf16", "f32", False, 32, F3_SMALL_ROWS, W5M_SEG, True),
            ("f32", "f32", False, 32, F3_SMALL_ROWS, SEG, True),
            ("bf16", "bf16", False, None, F3_SMALL_ROWS, W5M_SEG, True),
            ("bf16", "bf16", False, 8, F3_SMALL_ROWS, None, True))
# Operations an element, for the bound (bytes bound every case): forward
# scale, bias, max, subtract, exp, sum, divide, dropout scale; backward the
# same recompute and the dropout scale, product, sum, fused multiply-add and
# scale.
F3_OPS, F3_BWD_OPS = 10, 16


def f3_inputs(rows: int, seg, l_dt, out_dt, seed: int):
    """Logits (rows, 12, 128, 128), the layer's additive bias over a key
    mask with ~1 key in 4 padding (packed: block-diagonal over segments of
    `seg`; None: unpacked (rows, 1, 1, 128)), row 0's keys all masked, and a
    cotangent."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    shape = (rows, ATTN_HEADS, ATTN_SP, ATTN_SP)
    l = (4.0 * torch.randn(shape, generator=g, device="cuda")).to(l_dt)
    keys = torch.rand((rows, ATTN_SP), generator=g, device="cuda") > 0.25
    keys[0] = False
    if seg is None:
        bias = ((~keys).float() * -10000.0)[:, None, None, :]
    else:
        idx = torch.arange(ATTN_SP, device="cuda") // seg
        visible = (idx[:, None] == idx[None, :])[None] & keys[:, None, :]
        bias = torch.where(visible, 0.0, -10000.0)[:, None]
    gy = torch.randn(shape, generator=g, device="cuda").to(out_dt)
    return l, bias, gy


def _dropout(nbits, seed: int):
    return None if nbits is None else (seed, 0.1, nbits, None)


def check_f3() -> dict:
    """(a) of phase 14: each case's output and dl against the plain chain
    and its autograd VJP: bf16 within one bf16 ulp plus 1e-5 of the largest
    (y with dropout within two: the dropout's second rounding of a
    probability one ulp apart), f32 within rtol 1e-5, atol 1e-5 of the
    largest; dl identical across two backward calls; whether each equals
    the plain version bit for bit is printed."""
    errs, scale = {}, math.sqrt(ATTN_HD)
    for i, (ld, od, rl, nbits, rows, seg, backward) in enumerate(F3_CASES):
        l, bias, gy = f3_inputs(rows, seg, F_DT[ld], F_DT[od], seed=70 + i)
        drop = _dropout(nbits, 1000 + i)
        ll = l.detach().requires_grad_(backward)
        with torch.set_grad_enabled(backward):
            want = attn_softmax.attn_softmax_plain(ll, bias, scale, F_DT[od], rl, drop)
            dl_want = torch.autograd.grad(want, ll, gy)[0] if backward else None
            got = attn_softmax.attn_softmax(ll, bias, scale, F_DT[od], rl, drop)
        what = (f"F3 {ld}->{od} {'round' if rl else f'drop {nbits}'} at {rows:,} x "
                f"{ATTN_HEADS} x {ATTN_SP} x {ATTN_SP}, "
                f"{'unpacked' if seg is None else f'seg {seg}'}")
        ok, err = f_close(got, want, rows_summed=True, ulps=1 if drop is None else 2)
        require(ok and bool(torch.isfinite(got[0]).all()),
                f"{what}: y differs from the plain version (max abs err {err})")
        rec = {"y": err, "y_equal": bool(torch.equal(got, want))}
        del want
        if backward:
            (dl,), (dl2,) = [torch.autograd.grad(got, ll, gy, retain_graph=True)
                             for _ in range(2)]
            require(torch.equal(dl, dl2), f"{what}: dl differs between two calls")
            ok, rec["dl"] = f_close(dl, dl_want, rows_summed=True)
            require(ok and bool(torch.isfinite(dl[0]).all()),
                    f"{what}: dl differs (max abs err {rec['dl']})")
            rec["dl_equal"] = bool(torch.equal(dl, dl_want))
            del dl, dl2, dl_want
        log(f"F3 check {what}: " + ", ".join(f"{k} {v:.3g}" if isinstance(v, float)
                                             else f"{k} {v}" for k, v in rec.items()))
        errs[what] = rec
        del l, bias, gy, got, ll
        torch.cuda.empty_cache()
    return errs


def eager_encode(data_dir: str) -> dict:
    """(c) of phase 14: phase 4's batch (4,096 entities at L 32, BERT-base
    bf16) encoded through `fused_attention=False`, the layer the CLI runs
    (F3's inference variant), best of 5; its launches are read after it.
    Then, not counted, the same batch through K2, the yardstick: the two
    tables within 1e-2 (unit-norm embeddings) and their entities/s."""
    tok = WordPieceTokenizer(os.path.join(data_dir, "vocab.txt"))
    texts = [ln.split("\t")[1] for ln in open(
        os.path.join(data_dir, "entity2text.txt"), encoding="utf-8").read().splitlines()]
    ids, mask = tok.batch_encode(texts, SEG)
    cfg, params = make_model(num_relations=12)
    out = {}
    for fused in (False, True):
        c = dataclasses.replace(cfg, encoder=dataclasses.replace(
            cfg.encoder, fused_attention=fused))
        srv = serve.LinkPredictor(params=params, cfg=c, tokenizer=tok,
                                  max_len=SEG, device="cuda")
        table = srv._encode(srv.params, ids, mask)
        best = min(wall(lambda: srv._encode(srv.params, ids, mask))[1]  # noqa: B023
                   for _ in range(5))
        out[fused] = (table, best)
        if not fused:
            launches = read_counts()
    diff = (out[False][0] - out[True][0]).abs().max().item()
    require(diff <= 1e-2 and bool(torch.isfinite(out[False][0]).all()),
            f"(c) the eager and K2 encodes differ by {diff}")
    n = len(texts)
    rate = {f: n / out[f][1] for f in out}
    log(f"(c) encode of {n:,} entities at L {SEG} (BERT-base bf16) with "
        f"fused_attention=False (F3's inference variant): "
        f"{out[False][1] * 1e3:.2f} ms, {rate[False]:,.0f} entities/s; with K2 "
        f"{out[True][1] * 1e3:.2f} ms, {rate[True]:,.0f} entities/s "
        f"({100 * rate[False] / rate[True]:.1f}% of it); tables within {diff:.3g} "
        f"(limit 1e-2); launches {launches}")
    return {"eager_encode_ms": out[False][1] * 1e3,
            "eager_encode_entities_per_s": rate[False],
            "k2_encode_entities_per_s": rate[True], "eager_vs_k2": diff}, launches


def softmax_phase(data_dir: str, card: str) -> tuple[dict, dict]:
    """Phase 14: (a) F3 against its plain version (not counted); then, each
    with every count set to 0 just before it, (b) phase 6 (c)'s W5M step at
    remat=8 and (c) the eager encode. Returns the stats and the sum of (b)'s
    and (c)'s launches."""
    t0 = time.perf_counter()
    stats = {"f3_check": check_f3()}
    torch.cuda.empty_cache()
    reset_counts()
    w5m = w5m_train(data_dir, card)
    step_launches = read_counts()
    stats.update({"f3_" + k: v for k, v in w5m.items()})
    log(f"(b) W5M step at remat=8: launches {step_launches}")
    require(step_launches["F3"] > 0 and step_launches["F3 backward"] > 0,
            "F3 or its backward was never launched by the W5M step")
    torch.cuda.empty_cache()
    reset_counts()
    enc, enc_launches = eager_encode(data_dir)
    stats.update(enc)
    require(enc_launches["F3"] > 0 and enc_launches["K2"] == 0,
            "the eager encode did not take F3 (or took K2)")
    torch.cuda.empty_cache()
    launches = {k: step_launches[k] + enc_launches[k] for k in COUNTERS}
    for key in BY_KEYS:
        launches[key] = step_launches[key] + enc_launches[key]
    stats["phase14_s"] = time.perf_counter() - t0
    log(f"phase 14: {stats['phase14_s']:.1f} s")
    return stats, launches


# -- phase 15: the dropout masks inside the kernels ------------------------------

DROP_BITS = (8, 16, 32)
#: The W5M train step's dropout sites after packing (1,024 rows of two
#: 64-token segments): the hidden sites and the attention probabilities.
W5M_ROWS = W5M_TOKENS // ATTN_SP
W5M_SITES = ((W5M_ROWS, ATTN_SP, BERT_H), (W5M_ROWS, ATTN_HEADS, ATTN_SP, ATTN_SP))
#: Kernel names of torch's generator (torch.profiler), and the ops that
#: launch them.
RNG_KERNELS = ("distribution", "randint", "bernoulli", "philox")
RNG_OPS = ("aten::rand", "aten::randint", "aten::uniform_", "aten::random_",
           "aten::bernoulli", "aten::bernoulli_", "aten::normal_",
           "aten::rand_like", "aten::randint_like")
#: The step's draws that are not dropout masks: the sampler's randint and
#: rand (data/sampling.py).
SAMPLER_DRAWS = 2


def check_masks() -> dict:
    """(a) of phase 15, at the W5M train step's shapes, each dropout_bits on
    a block of a larger site: F3's masks, forward (y != 0 where kept, with
    uniform probabilities) and backward (the sign of dl under a unit
    cotangent), equal to the plain generator's; F2's s = x + drop(r) and dr
    = drop(ds) bit-equal to the plain chain; the site kernel's drop(x) and
    drop(g) bit-equal to the plain version."""
    out = {}
    eps = bert.BertConfig().layer_norm_eps
    shape = (W5M_ROWS, ATTN_HEADS, ATTN_SP, ATTN_SP)
    for nbits in DROP_BITS:
        # F3: the second half of the rows and heads of a site twice as big.
        block = ((2 * W5M_ROWS, 2 * ATTN_HEADS, ATTN_SP, ATTN_SP),
                 (W5M_ROWS // 2, ATTN_HEADS, 0, 0))
        drop = (0xF3F3F3F3F3 + nbits, 0.5, nbits, block)
        l = torch.zeros(shape, device="cuda", dtype=torch.bfloat16,
                        requires_grad=True)
        bias = torch.zeros((W5M_ROWS, 1, 1, ATTN_SP), device="cuda")
        y = attn_softmax.attn_softmax(l, bias, 8.0, torch.bfloat16, dropout=drop)
        dl, = torch.autograd.grad(y, l, torch.ones_like(y))
        keep = dropout_rng.site_keep(drop[0], 0.5, nbits, shape, block, "cuda")[0]
        require(torch.equal(y != 0, keep) and torch.equal(dl.float() > 0, keep)
                and not bool((dl == 0).any()),
                f"F3's {nbits}-bit masks differ from the plain generator's")
        kept = keep.float().mean().item()
        del l, y, dl, keep
        # F2: the rows past the first 4,096 of a hidden site.
        first = W5M_TOKENS // 32
        x, r, scale, bias_, gy = f2_inputs(W5M_TOKENS, True, torch.bfloat16,
                                           torch.bfloat16, seed=80 + nbits)
        drop = (0xF2F2F2F2F2 + nbits, 0.1, nbits,
                ((W5M_TOKENS + first, BERT_H), (first, 0)))
        _, s, mean, rstd = fused_layer._add_layer_norm_kernel(
            x, r, scale, bias_, eps, torch.bfloat16, drop)
        ok_s = torch.equal(s, x + fused_layer.site_dropout_plain(r, drop))
        ds, dr, _, _ = fused_layer._add_layer_norm_backward_kernel(
            gy, s, mean, rstd, scale, drop)
        ok_dr = torch.equal(dr, fused_layer.site_dropout_plain(ds, drop))
        require(ok_s and ok_dr, f"F2 with {nbits}-bit masks: s or dr differ from "
                                "the plain chain")
        del s, mean, rstd, ds, dr, r, scale, bias_
        # The site kernel: the same rows, forward and backward.
        xx = x.detach().requires_grad_()
        yy = bert._rng_dropout(xx, drop[0], 0.1, nbits, drop[3])
        dx, = torch.autograd.grad(yy, xx, gy)
        require(torch.equal(yy, fused_layer.site_dropout_plain(x, drop))
                and torch.equal(dx, fused_layer.site_dropout_plain(gy, drop)),
                f"the site kernel with {nbits}-bit masks differs from the plain "
                "version")
        del x, xx, yy, dx, gy
        torch.cuda.empty_cache()
        out[nbits] = {"f3_kept": kept}
        log(f"(a) {nbits}-bit masks at the W5M shapes (blocks of larger sites): "
            f"F3 forward and backward, F2's s and dr, the site kernel's drop(x) "
            f"and drop(g) equal the plain generator's; F3 kept {kept:.6f} "
            f"(keep_p {dropout_rng.threshold(0.5, nbits)[1]})")
    return out


#: Kernel names of torch's copies (casts, `contiguous`, permuted reshapes).
COPY_KERNELS = ("direct_copy", "bfloat16_copy")


def copies_by_shape(prof, source=None) -> list:
    """[(op, input shapes, device ms, launches)] of the copy kernels in a
    profile recorded with shapes, each charged to the op that launched it
    (named `source(op)` where given, else by its name), by device time."""
    rows = collections.defaultdict(lambda: [0.0, 0])
    for e in prof.events():
        ks = [k for k in e.kernels if any(p in k.name for p in COPY_KERNELS)]
        if ks:
            r = rows[e.name if source is None else source(e), str(e.input_shapes)]
            r[0] += sum(k.duration for k in ks) / 1e3
            r[1] += len(ks)
    return sorted(((n, sh, ms, c) for (n, sh), (ms, c) in rows.items()),
                  key=lambda r: -r[2])


def rng_free_step(label: str, step, sites) -> dict:
    """One step under torch.profiler (shapes recorded): its kernels by name,
    and what it asks of torch's generator and of `where`. Requires no draw
    and no `where` on a dropout site's shape (`sites`), and no more RNG
    kernels than the sampler's two draws."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = sorted(((e.key, e.self_device_time_total / 1e3, e.count)
                      for e in prof.key_averages()
                      if e.device_type == torch.autograd.DeviceType.CUDA),
                     key=lambda k: -k[1])
    busy = sum(ms for _, ms, _ in kernels)
    rng = sum(c for n, _, c in kernels if any(k in n for k in RNG_KERNELS))
    where = sum(c for n, _, c in kernels if "where_kernel" in n)
    on_sites = [(e.name, e.input_shapes) for e in prof.events()
                if (e.name in RNG_OPS or e.name == "aten::where")
                and any(tuple(sh) in sites for sh in e.input_shapes or ())]
    copies = copies_by_shape(prof)
    log(f"(b) {label}: profiled wall {wall_ms:.1f} ms, device busy {busy:.1f} ms; "
        f"RNG kernels {rng}, where kernels {where}, draws or wheres on a dropout "
        f"site {len(on_sites)}")
    log(f"(b) {label}: copies {sum(c[2] for c in copies):.2f} ms x"
        f"{sum(c[3] for c in copies)}; by shape: " + "; ".join(
            f"{n} {sh} {ms:.2f} ms x{c}" for n, sh, ms, c in copies[:12]))
    for name, ms, count in kernels[:25]:
        log(f"    {ms:8.2f} ms x{count:<5d} {name[:110]}")
    require(not on_sites, f"{label}: torch draws or selects on a dropout site: "
                          f"{on_sites[:4]}")
    require(rng <= SAMPLER_DRAWS, f"{label}: {rng} RNG kernels, more than the "
                                  f"sampler's {SAMPLER_DRAWS}")
    return {"wall_ms": wall_ms, "busy_ms": busy, "rng_kernels": rng,
            "where_kernels": where, "copies_by_shape": copies,
            "kernels": [(n[:200], round(ms, 3), c) for n, ms, c in kernels[:60]]}


def w5m_steps_profiled(data_dir: str) -> tuple[dict, dict]:
    """(b) of phase 15: phase 6 (c)'s W5M step (remat=8, 32-bit masks) and
    the bench --w5m point's step (remat=4, fast_train, 8-bit masks), each
    after warm-up steps, profiled by kernel name; the launches of both."""
    from blp_tpu_torch import bench

    stats = {}
    cfg, params = train_model(12, remat=8)
    opt = training.make_optimizer(5e-5, 1000)
    state = opt.init(params)
    step = training.make_train_step(cfg, opt, batch_size=1024, num_negatives=64,
                                    device="cuda")
    batches = train_batches(data_dir, 64, 1024, 3)
    times = []
    for i, batch in enumerate(batches):
        (params, state, _), s = wall(lambda: step(params, state, (0, i), batch))  # noqa: B023
        times.append(s * 1e3)
    stats["w5m_step_ms"] = times
    log(f"(b) W5M step (remat=8): {[round(t, 1) for t in times]} ms for steps 1-3")
    stats["w5m_step_profile"] = rng_free_step(
        "W5M step at remat=8", lambda: step(params, state, (0, 3), batches[0]),
        W5M_SITES)
    del params, state, step, batches
    torch.cuda.empty_cache()
    (B, L, K), _ = bench.W5M["shape"], bench.W5M["timing"]
    step, params, state, batch = bench.setup(B, L, K, bench.model_config(bench.W5M),
                                             DEVICE)
    for i in range(3):
        params, state, _ = step(params, state, (0, i), batch)
    stats["bench_w5m_profile"] = rng_free_step(
        "bench --w5m step (remat=4, fast_train, 8-bit masks)",
        lambda: step(params, state, (0, 3), batch), W5M_SITES)
    del params, state, step, batch
    torch.cuda.empty_cache()
    return stats


def dropout_phase(data_dir: str) -> tuple[dict, dict]:
    """Phase 15: (a) the masks against the plain generator (not counted);
    then, with every count set to 0, (b) the W5M step and the bench --w5m
    step, profiled. Returns the stats and (b)'s launches."""
    t0 = time.perf_counter()
    stats = {"mask_check": check_masks()}
    torch.cuda.empty_cache()
    reset_counts()
    stats.update(w5m_steps_profiled(data_dir))
    launches = read_counts()
    require(all(launches[k] > 0 for k in ("F2", "F2 backward", "F3", "F3 backward",
                                          "site dropout")),
            f"a kernel that carries a dropout site was never launched: {launches}")
    stats["phase15_s"] = time.perf_counter() - t0
    log(f"phase 15: {stats['phase15_s']:.1f} s")
    return stats, launches


# -- phase 7: timings at the main path's shapes ----------------------------------

def sm_clock_running(fn, ms: float) -> str:
    """nvidia-smi's SM clock and its maximum, read while about 0.6 s of calls
    of `fn` (`ms` each) are queued on the card."""
    for _ in range(int(600 / ms) + 1):
        fn()
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    torch.cuda.synchronize()
    return out.stdout.strip().splitlines()[0]


def _time_k1_at(d: int, plain_reps: int) -> dict:
    """K1 at the Wikidata5M candidate count and width d: counts against the
    plain version's, kernel ms (CUDA events, 10 calls), the SM clock read
    right after with the kernel running, plain ms, bound, and the retained
    "scalar" variant's ms on the same values in a view 4 bytes off (3
    calls). The bound counts K1's own operations: 2 fp32 adds per (query,
    candidate, dim) of the d real dims, over 33.5e12/s."""
    n = W5M_ENTITIES
    table, u, r, pos = k1_inputs(n, n, seed=3, d=d)
    require(k1_variant(table, u) == "tma", f"K1 at d={d} would not take its tma variant")
    kernel = lambda: transe_rank.raw_counts(table, u, r, pos, n)  # noqa: E731
    got = kernel()
    want, plain_s = wall(lambda: transe_rank.raw_counts_plain(table, u, r, pos, n))
    err = (got - want).abs().max().item()
    require(err == 0, f"K1 counts differ at the Wikidata5M shape, d={d}, by {err}")
    ms = cuda_ms(kernel, reps=10)
    clock = sm_clock_running(kernel, ms)
    plain_ms = (plain_s * 1e3 if plain_reps == 1 else cuda_ms(
        lambda: transe_rank.raw_counts_plain(table, u, r, pos, n), reps=plain_reps))
    old = offset_copy(table)
    del table
    require(k1_variant(old, u) == "scalar", "K1's offset view would not take its scalar variant")
    scalar = lambda: transe_rank.raw_counts(old, u, r, pos, n)  # noqa: E731
    require(torch.equal(scalar(), want), f"K1 (scalar) counts differ at d={d}")
    scalar_ms = cuda_ms(scalar, reps=3)
    require(ms < scalar_ms, f"K1's tma variant is not faster than its scalar one at d={d}")
    ops = 2.0 * K1_Q * n * d
    nbytes = 4.0 * (n * d + K1_Q * d + 2 * K1_Q + 2 * K1_Q)
    t_ops, t_bytes = ops / FP32_ADDS_PER_S * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    del old
    torch.cuda.empty_cache()
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "scalar_ms": scalar_ms, "sm_clock": clock,
            "shape": f"Q={K1_Q} Np={n} d={d} fp32"}


def time_k1(launches: int, by_variant: dict) -> dict:
    """K1 at d 128 (the record's numbers) and at the word models' widths
    (under `at_d300`, `at_d768`; their plain version is timed once).
    `by_variant`: the main path's launches as {variant: {d: launches}}."""
    rec = _time_k1_at(K1_D, plain_reps=2)
    subs = {f"at_d{d}": _time_k1_at(d, plain_reps=1) for d in WORD_DIMS}
    return {"name": "transe_rank (K1)", "route": "cuda",
            "source": "blp_tpu_torch/csrc/transe_rank.cu",
            "replaces": "blp_tpu/ops/pallas_ranking.py:57",
            "launches": launches, "launches_by_variant": by_variant, **rec,
            "library_ms": None, **subs}


def _time_k2_at(b: int, seg: int) -> dict:
    """K2 at b packed rows of Sp / seg segments (about 1 row in 8 ending in
    empty segments): max error and the share of outputs more than one bf16
    ulp from the plain version, kernel ms (CUDA events, 20 calls), plain ms,
    SDPA ms (additive bias, same inputs) and the bound: q, k, v and the
    output in bf16 over the memory rate, or the full Sp x Sp products over
    the bf16 tensor rate, whichever is larger."""
    _, nh, sp, hd = K2_SHAPE
    q, k, v, mask = k2_inputs(b, seed=4, seg=seg)
    scale = 1.0 / math.sqrt(hd)
    got = packed_attention.block_diag_attention(q, k, v, mask, seg=seg, scale=scale)
    want = packed_attention.block_diag_attention_plain(q, k, v, mask, seg=seg,
                                                       scale=scale)
    err = (got.float() - want.float()).abs().max().item()
    require(torch.allclose(got.float(), want.float(), rtol=2e-2, atol=2e-2),
            f"K2 error {err} at {b} rows, seg {seg}")
    ulp_share = over_one_ulp(got, want)
    del got, want
    torch.cuda.empty_cache()
    ms = cuda_ms(lambda: packed_attention.block_diag_attention(
        q, k, v, mask, seg=seg, scale=scale), reps=20, warmup=3)
    plain_ms = cuda_ms(lambda: packed_attention.block_diag_attention_plain(
        q, k, v, mask, seg=seg, scale=scale), reps=3)
    torch.cuda.empty_cache()
    bias = packed_attention.block_bias(mask, seg).to(torch.bfloat16)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    library_ms = cuda_ms(lambda: sdpa(q, k, v, attn_mask=bias, scale=scale),
                         reps=20, warmup=3)
    nbytes = 2.0 * 4 * b * nh * sp * hd + 4.0 * b * sp
    flops = 2.0 * 2 * b * nh * sp * sp * hd
    t_ops, t_bytes = flops / BF16_TENSOR_FLOPS * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    del q, k, v, mask, bias
    torch.cuda.empty_cache()
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": library_ms, "over_1ulp_share": ulp_share,
            "shape": f"B={b} nh={nh} Sp={sp} hd={hd} seg={seg} bf16, about "
                     f"1 row in 8 with empty tail segments"}


def time_k2(launches: int, by_seg: dict) -> dict:
    """K2 at the main path's table-build shape (the record's numbers) and at
    the Wikidata5M phase-1 chunk (under `at_seg64`). `by_seg`: the main
    path's launches by segment length."""
    rec = _time_k2_at(K2_SHAPE[0], SEG)
    return {"name": "packed_attention (K2)", "route": "cuda",
            "source": "blp_tpu_torch/csrc/packed_attention.cu",
            "replaces": "blp_tpu/ops/pallas_attention.py:56",
            "launches": launches, "launches_by_seg": by_seg, **rec,
            "at_seg64": {**_time_k2_at(W5M_K2_ROWS, W5M_SEG),
                         "launches": by_seg.get(W5M_SEG, 0)}}


def _k3_plain_vjp(ent, rel, neg, g_pos, g_neg, rel_model):
    """The parent design's backward: the plain formulation re-run under
    autograd on the saved inputs, then its VJP (scorer and index
    backward)."""
    with torch.enable_grad():
        e = ent.detach().requires_grad_()
        r = rel.detach().requires_grad_()
        out = sddmm.sddmm_scores_plain(e, r, neg, rel_model)
        return torch.autograd.grad(out, (e, r), (g_pos, g_neg))


def _time_k3_at(b: int, d: int = K3_D) -> tuple[dict, dict]:
    """Forward and backward records at batch size b and width d (TransE,
    K 64)."""
    ent, rel, neg = k3_inputs(b, seed=20, d=d)
    got = sddmm.sddmm_scores(ent, rel, neg, "transe")
    want = sddmm.sddmm_scores_plain(ent, rel, neg, "transe")
    err = max((x - y).abs().max().item() for x, y in zip(got, want))
    require(err <= 1e-5 * (1 + max(y.abs().max().item() for y in want)),
            f"K3 error {err} at B={b} d={d}")
    kernel = lambda: sddmm.sddmm_scores(ent, rel, neg, "transe")  # noqa: E731
    plain = lambda: sddmm.sddmm_scores_plain(ent, rel, neg, "transe")  # noqa: E731
    (ms, _, _), (plain_ms, _, _) = device_ms(kernel, reps=100), device_ms(
        plain, reps=100)
    call_ms = cuda_ms(kernel, reps=200, warmup=5)
    # Each input read once, each output written once; the gathered rows are
    # re-reads of ent, which stays in L2.
    nbytes = 4.0 * (2 * b * d + b * d + b * K3_K * 2 + b + b * K3_K)
    ops = float(K3_TRANSE_OPS) * b * (K3_K + 1) * d
    t_ops, t_bytes = ops / FP32_ADDS_PER_S * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    fwd = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
           "call_ms": call_ms, "bound_ms": max(t_ops, t_bytes),
           "bound_by": "operations" if t_ops >= t_bytes else "bytes",
           "shape": f"B={b} K={K3_K} d={d} fp32 transe"}

    # Backward: margin-loss-sized cotangents.
    g = torch.Generator(device="cuda").manual_seed(21)
    g_pos = torch.randn((b, 1), generator=g, device="cuda") / (b * K3_K)
    g_neg = torch.randn((b, K3_K), generator=g, device="cuda") / (b * K3_K)
    args = (ent, rel, neg, g_pos, g_neg, "transe")
    got = sddmm._sddmm_backward_kernel(*args)
    want = _k3_plain_vjp(*args)
    err = max((x - y).abs().max().item() for x, y in zip(got, want))
    require(all(torch.allclose(x, y, rtol=1e-5, atol=1e-6)
                for x, y in zip(got, want)),
            f"K3 backward error {err} at B={b} d={d}")
    ms, per_call, by_name = device_ms(lambda: sddmm._sddmm_backward_kernel(*args),
                                      reps=100)
    plain_ms, plain_per_call, _ = device_ms(lambda: _k3_plain_vjp(*args),
                                            reps=100)
    kernel_ms = sum(v for k, v in by_name.items() if "sddmm_bwd" in k)
    log(f"K3 backward at B={b} d={d}, device ms per call by kernel: " + "; ".join(
        f"{v:.4f} {k[:60]}" for k, v in sorted(by_name.items(),
                                                key=lambda x: -x[1])))
    # Inputs read once (ent, rel, neg_idx, the cotangents), outputs written
    # once (d_ent, d_rel).
    nbytes = 4.0 * (2 * b * d + b * d + b * K3_K * 2 + b + b * K3_K
                    + 2 * b * d + b * d)
    ops = float(K3_TRANSE_BWD_OPS) * b * (K3_K + 1) * d
    t_ops, t_bytes = ops / FP32_ADDS_PER_S * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    bwd = {"max_abs_err": err, "ms": ms, "kernel_ms": kernel_ms,
           "plain_ms": plain_ms, "launches_per_call": per_call,
           "plain_launches_per_call": plain_per_call,
           "bound_ms": max(t_ops, t_bytes),
           "bound_by": "operations" if t_ops >= t_bytes else "bytes",
           "shape": f"B={b} K={K3_K} d={d} fp32 transe"}
    return fwd, bwd


def time_k3(launches: int, backward_launches: int) -> list[dict]:
    """K3's forward and backward at the flagship batch (the records'
    numbers), at the Wikidata5M batch (under `at_b1024`) and at the word
    models' widths at B 64 (under `at_d300`, `at_d768`). `ms` and
    `plain_ms` are device time per call (device_ms); the forward's `call_ms`
    is the wrapper's time per call from CUDA events around 200 back-to-back
    calls, host launch path included. The backward's `ms` is its kernel
    with the index bookkeeping (`kernel_ms` the kernel alone), its
    `plain_ms` the plain formulation's VJP; `launches_per_call` counts the
    device launches of one call of each."""
    (f64, b64), (f1024, b1024) = (_time_k3_at(b) for b in K3_BATCHES)
    words = {f"at_d{d}": _time_k3_at(64, d) for d in WORD_DIMS}
    common = {"route": "cuda", "source": "blp_tpu_torch/csrc/sddmm.cu",
              "library_ms": None}
    return [{"name": "sddmm (K3)", **common,
             "replaces": "blp_tpu/ops/pallas_sddmm.py:45",
             "launches": launches, **f64, "at_b1024": f1024,
             **{k: fb[0] for k, fb in words.items()}},
            {"name": "sddmm backward (K3)", **common,
             "replaces": "blp_tpu/ops/pallas_sddmm.py:148",
             "launches": backward_launches, **b64, "at_b1024": b1024,
             **{k: fb[1] for k, fb in words.items()}}]


# F1's and F2's f32 operations an element, counted in csrc/fused_layer.cu's
# formulas (erff and expf one each; the poly backward recomputes the forward).
F1_OPS = {"none": 1, "erf": 6, "poly": 21}
F1_BWD_OPS = {"none": 1, "erf": 14, "poly": 48}
F2_OPS, F2_BWD_OPS = 9, 14


def _bound(nbytes: float, ops: float) -> dict:
    t_ops, t_bytes = ops / FP32_ADDS_PER_S * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    return {"bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def _blockwise(fn, rows: int, block: int = W5M_TOKENS):
    """fn(start, stop) over row blocks: the plain versions at the encode
    chunk's rows, whose f32 temporaries at once would not fit."""
    return lambda: [fn(i, min(i + block, rows)) for i in range(0, rows, block)]


def _time_f1_at(act: str, rows: int, w: int, head_dim=None) -> dict:
    """F1's forward at (rows, w) bf16 (head_dim: y head-major, rows as
    sequences of 128): kernel and plain ms (CUDA events), the library's
    nearest call (for "none" h + b in bf16, the whole function row-major;
    else F.gelu on the biased input: the erf activation alone), the bound
    (h and y in bf16 and b, or its operations)."""
    bf = torch.bfloat16
    h, b, _ = f1_inputs(rows, w, bf, bf, seed=50)
    if head_dim is not None:
        h = h.view(rows // 128, 128, w)
    with torch.no_grad():
        got = fused_layer.bias_act(h, b, act, bf, head_dim=head_dim)
        if head_dim is None:
            want = torch.cat(_blockwise(lambda i, j: fused_layer.bias_act_plain(
                h[i:j], b, act, bf), rows)())
        else:
            want = fused_layer.bias_act_plain(h, b, act, bf, head_dim=head_dim)
        err = (got.float() - want.float()).abs().max().item()
        require(within_ulp(got, want), f"F1 {act} at {rows} x {w}: error {err}")
        del got, want
        ms = cuda_ms(lambda: fused_layer.bias_act(h, b, act, bf, head_dim=head_dim),
                     reps=20, warmup=3)
        if head_dim is None:
            plain_ms = cuda_ms(_blockwise(lambda i, j: fused_layer.bias_act_plain(
                h[i:j], b, act, bf), rows), reps=3)
        else:
            plain_ms = cuda_ms(lambda: fused_layer.bias_act_plain(
                h, b, act, bf, head_dim=head_dim), reps=3)
        if act == "none":
            b16 = b.to(bf)
            library_ms = cuda_ms(lambda: h + b16, reps=20, warmup=3)
            covers = "h + b in bf16: all of it, row-major"
        else:
            pre = fused_layer.bias_act_plain(h, b, "none", bf)
            library_ms = cuda_ms(lambda: torch.nn.functional.gelu(pre), reps=20,
                                 warmup=3)
            covers = "F.gelu (erf) on the biased bf16 input: the activation alone"
            del pre
    del h
    torch.cuda.empty_cache()
    layout = "" if head_dim is None else f", y head-major (B, {w // head_dim}, 128, {head_dim})"
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            **_bound(4.0 * rows * w + 4.0 * w, float(F1_OPS[act]) * rows * w),
            "library_ms": library_ms, "library_covers": covers,
            "shape": f"{rows:,} x {w} {act} bf16->bf16{layout}"}


def _time_f1_backward_at(act: str, rows: int, w: int, cotangent=None) -> dict:
    """F1's backward kernel (dh and db in one launch; for "none" with a
    row-major cotangent, where dh is g, db alone; cotangent "q" or "k": a
    head-major one, rows as sequences of 128, turned into dh's rows) against
    the plain chain's VJP (recomputed from h and b, as the CPU backward
    does) and the nearest library call: aten.gelu_backward on the rounded
    pre-activation; for "none" g's f32 column sum, which is the whole
    function; for a head-major cotangent its permute copy alone."""
    bf = torch.bfloat16
    h, b, gy = f1_inputs(rows, w, bf, bf, seed=51)
    head_dim = None if cotangent is None else F1_HEAD_DIM
    if cotangent is not None:
        h = h.view(rows // 128, 128, w)
        gy = f1_head_cotangent(rows // 128, 128, cotangent, seed=52)

    def plain_vjp():
        with torch.enable_grad():
            hh, bb = h.detach().requires_grad_(), b.detach().requires_grad_()
            return torch.autograd.grad(fused_layer.bias_act_plain(
                hh, bb, act, bf, head_dim=head_dim), (hh, bb), gy)

    kernel = lambda: fused_layer._bias_act_backward_kernel(  # noqa: E731
        gy, h, b, act, bf, True, head_dim=head_dim)
    (dh, db), (dh_p, db_p) = kernel(), plain_vjp()
    err = (dh.float() - dh_p.float()).abs().max().item()
    require(within_ulp(dh, dh_p) and sum_close(db, db_p)[0],
            f"F1 backward {act} at {rows} x {w}: dh error {err}")
    del dh, db, dh_p, db_p
    ms = cuda_ms(kernel, reps=20, warmup=3)
    plain_ms = cuda_ms(plain_vjp, reps=2)
    if cotangent is not None:
        library_ms = cuda_ms(lambda: gy.permute(0, 2, 1, 3).contiguous(), reps=20,
                             warmup=3)
        covers = "g.permute(0, 2, 1, 3).contiguous(): the copy to rows alone, no db"
        # g read, dh written (bf16); db written (f32).
        nbytes = 4.0 * rows * w + 4.0 * w
    elif act == "none":
        library_ms = cuda_ms(lambda: gy.sum(0, dtype=torch.float32), reps=20,
                             warmup=3)
        covers = "g.sum(0, dtype=torch.float32): all of it (dh is g)"
        # g read (bf16), db written (f32).
        nbytes = 2.0 * rows * w + 4.0 * w
    else:
        pre = fused_layer.bias_act_plain(h, b, "none", bf)
        library_ms = cuda_ms(lambda: torch.ops.aten.gelu_backward(gy, pre),
                             reps=20, warmup=3)
        del pre
        covers = ("aten.gelu_backward (erf) on the rounded pre-activation: the "
                  "activation's derivative alone, no db")
        # g, h read and dh written (bf16); b read and db written (f32).
        nbytes = 6.0 * rows * w + 8.0 * w
    del h, gy
    torch.cuda.empty_cache()
    layout = "" if cotangent is None else (
        f", {cotangent}'s head-major cotangent" + (" held (B, nh, hd, S)"
                                                    if cotangent == "k" else ""))
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            **_bound(nbytes, float(F1_BWD_OPS[act]) * rows * w),
            "library_ms": library_ms, "library_covers": covers,
            "shape": f"{rows:,} x {w} {act} bf16->bf16{layout}"}


def time_f1(launches: int, backward_launches: int, by_variant: dict) -> list[dict]:
    """F1 at the W5M train step's FFN (131,072 x 3072, poly: fast_train),
    and at 768 wide ("none": q, k, v, attn_out, ffn_out; q, k and v
    head-major, forward and, backward, from q's and k's cotangents) and the
    encode chunk's FFN (786,432 x 3072, forward) under `at_*`."""
    common = {"route": "cuda", "source": "blp_tpu_torch/csrc/fused_layer.cu",
              "replaces": "blp_tpu/models/bert.py:282",
              "xla_fusion": "no Pallas kernel: XLA fuses _dense's bias add "
                            "(:282) with poly_gelu (:305) or jax.nn.gelu, and "
                            "the head-major projections' (:411-415)"}
    fwd = {"name": "bias_act (F1)", **common, "launches": launches,
           "launches_by_variant": by_variant.get("bias_act", {}),
           **_time_f1_at("poly", W5M_TOKENS, BERT_I),
           "at_w768_none": _time_f1_at("none", W5M_TOKENS, BERT_H),
           "at_w768_none_heads": _time_f1_at("none", W5M_TOKENS, BERT_H,
                                             head_dim=F1_HEAD_DIM),
           "at_encode": _time_f1_at("poly", ENCODE_TOKENS, BERT_I)}
    bwd = {"name": "bias_act backward (F1)", **common,
           "launches": backward_launches,
           "launches_by_variant": by_variant.get("bias_act backward", {}),
           **_time_f1_backward_at("poly", W5M_TOKENS, BERT_I),
           "at_w768_none": _time_f1_backward_at("none", W5M_TOKENS, BERT_H),
           "at_heads_q": _time_f1_backward_at("none", W5M_TOKENS, BERT_H, "q"),
           "at_heads_k": _time_f1_backward_at("none", W5M_TOKENS, BERT_H, "k")}
    return [fwd, bwd]


def _f2_plain_blocks(x, r, scale, bias, eps, drop, rows):
    """The plain F2 over row blocks, each its block of the dropout site."""
    def block(i, j):
        d = None if drop is None else (*drop[:3], ((rows, BERT_H), (i, 0)))
        return fused_layer.add_layer_norm_plain(x[i:j], r[i:j], scale, bias, eps,
                                                torch.bfloat16, d)
    return _blockwise(block, rows)


def _time_f2_at(rows: int, nbits=None, keep_sum: bool = True,
                with_r: bool = True) -> dict:
    """F2's forward (x + drop(r), bf16; no dropout when nbits is None) at
    (rows, 768), writing the saved sum s (the training pass) or not
    (keep_sum False: an encode); with_r False: the embedding LayerNorm, LN
    of an f32 x alone to bf16. Kernel and plain ms, F.layer_norm on the
    added input (the library's nearest call: no add, no dropout; bf16 scale
    and bias; f32 ones on the f32 x), the bound (x, r, y and s, the row
    stats; the operations with the generator's)."""
    bf = torch.bfloat16
    eps = bert.BertConfig().layer_norm_eps
    x_dt = bf if with_r else torch.float32
    x, r, scale, bias, _ = f2_inputs(rows, with_r, x_dt, bf, seed=52)
    drop = _dropout(nbits, 9)
    if with_r:
        plain = _f2_plain_blocks(x, r, scale, bias, eps, drop, rows)
    else:
        plain = _blockwise(lambda i, j: fused_layer.add_layer_norm_plain(
            x[i:j], None, scale, bias, eps, bf), rows)
    kernel = lambda: fused_layer._add_layer_norm_kernel(  # noqa: E731
        x, r, scale, bias, eps, bf, drop, keep_sum)[0]
    with torch.no_grad():
        ok, err = f_close(kernel(), torch.cat(plain()), rows_summed=True)
        require(ok, f"F2 at {rows}, dropout bits {nbits}, with r {with_r}: error {err}")
        ms = cuda_ms(kernel, reps=20, warmup=3)
        plain_ms = cuda_ms(plain, reps=3)
        s = x + r if with_r else x
        sc, bi = (scale.to(bf), bias.to(bf)) if with_r else (scale, bias)
        library_ms = cuda_ms(lambda: torch.nn.functional.layer_norm(
            s, (BERT_H,), sc, bi, eps), reps=20, warmup=3)
    del x, r, s
    torch.cuda.empty_cache()
    w = BERT_H
    if with_r:
        kind = ("x+r" if nbits is None else f"x+drop{nbits}(r)") + (
            "" if keep_sum else ", no saved sum")
        # x and r read, y (and s) written, bf16
        row_bytes, covers = (8.0 if keep_sum else 6.0), (
            "F.layer_norm on x + r (bf16 scale and bias): no residual add, "
            "no dropout, no saved sum")
    else:
        kind = "x alone (the embedding sum)"
        # x read (f32), y written (bf16)
        row_bytes = 6.0
        covers = "F.layer_norm on the f32 x (f32 out): all of it but the bf16 cast"
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            **_bound(row_bytes * rows * w + 8.0 * rows + 8.0 * w,
                     (F2_OPS + _philox_ops(nbits)) * rows * w),
            "library_ms": library_ms, "library_covers": covers,
            "shape": f"{rows:,} x {w} {kind} {'bf16' if with_r else 'f32'}->bf16"}


def _time_f2_backward_at(rows: int, nbits=None) -> dict:
    """F2's backward kernel (one launch: ds, dscale, dbias, and with dropout
    dr, its mask evaluated again) against the plain LayerNorm's VJP from the
    saved sum (then the plain dropout of ds) and
    aten.native_layer_norm_backward, the kernel and the library call timed
    in turns."""
    bf = torch.bfloat16
    eps = bert.BertConfig().layer_norm_eps
    x, r, scale, bias, gy = f2_inputs(rows, True, bf, bf, seed=53)
    drop = _dropout(nbits, 10)
    with torch.no_grad():
        _, s, mean, rstd = fused_layer._add_layer_norm_kernel(x, r, scale, bias,
                                                              eps, bf, drop)
    del x, r

    def plain_vjp():
        with torch.enable_grad():
            ins = [t.detach().requires_grad_() for t in (s, scale, bias)]
            y = fused_layer.add_layer_norm_plain(ins[0], None, ins[1], ins[2], eps, bf)
            got = torch.autograd.grad(y, ins, gy)
        dr = None if drop is None else fused_layer.site_dropout_plain(got[0], drop)
        return got[0], dr, *got[1:]

    kernel = lambda: fused_layer._add_layer_norm_backward_kernel(  # noqa: E731
        gy, s, mean, rstd, scale, drop)
    got, want = kernel(), plain_vjp()
    ok, err = f_close(got[0], want[0], rows_summed=True)
    require(ok and all(sum_close(a, b)[0] for a, b in zip(got[2:], want[2:])),
            f"F2 backward at {rows}, dropout bits {nbits}: ds error {err}")
    require(drop is None or torch.equal(
        got[1], fused_layer.site_dropout_plain(got[0], drop)),
        f"F2 backward at {rows}: dr is not drop(ds) of the plain generator")
    del got, want
    sc, bi = scale.to(bf), bias.to(bf)
    _, mu, rs = torch.ops.aten.native_layer_norm(s, [BERT_H], sc, bi, eps)
    # In turns: a time read right after the plain version's ~56 ms read up
    # to 20% slow.
    ms, library_ms = cuda_ms_in_turns(kernel, lambda: torch.ops.aten.native_layer_norm_backward(
        gy, s, [BERT_H], mu, rs, sc, bi, [True, True, True]))
    plain_ms = cuda_ms(plain_vjp, reps=3)
    del s, gy
    torch.cuda.empty_cache()
    w = BERT_H
    # g and s read, ds (and dr) written (bf16); the row stats and scale read;
    # dscale and dbias written.
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            **_bound((6.0 if drop is None else 8.0) * rows * w + 8.0 * rows
                     + 12.0 * w, (F2_BWD_OPS + _philox_ops(nbits)) * rows * w),
            "library_ms": library_ms, "library_covers":
                "aten.native_layer_norm_backward (bf16 scale): the LayerNorm's "
                "backward alone, no dropout",
            "shape": f"{rows:,} x {w} bf16->bf16"
                     + ("" if nbits is None else f", dr drop {nbits}")}


def time_f2(launches: int, backward_launches: int, by_variant: dict) -> list[dict]:
    """F2 at the W5M train step's rows (131,072 x 768): forward without
    dropout, writing the saved sum (as the kernel once always did), without it
    (`at_no_sum`: an encode's call), with 8- and 32-bit masks (`at_drop8`,
    `at_drop32`: the training layers'), the embedding LayerNorm's f32 x
    alone (`at_emb`) and at the encode chunk's 786,432 rows (`at_encode`,
    no saved sum); backward (one launch: ds, dr, dscale and dbias) with
    8-bit masks (dr beside ds), 32-bit ones and none (`at_drop32`,
    `at_no_dropout`)."""
    common = {"route": "cuda", "source": "blp_tpu_torch/csrc/fused_layer.cu",
              "replaces": "blp_tpu/models/bert.py:270",
              "xla_fusion": "no Pallas kernel: XLA fuses the residual add with "
                            "_layer_norm (:270) and the hidden sites' "
                            "_rng_dropout (:453-456, :472-475)"}
    return [{"name": "add_layer_norm (F2)", **common, "launches": launches,
             "launches_by_variant": by_variant.get("add_layer_norm", {}),
             **_time_f2_at(W5M_TOKENS),
             "at_no_sum": _time_f2_at(W5M_TOKENS, keep_sum=False),
             "at_drop8": _time_f2_at(W5M_TOKENS, 8),
             "at_drop32": _time_f2_at(W5M_TOKENS, 32),
             "at_emb": _time_f2_at(W5M_TOKENS, keep_sum=False, with_r=False),
             "at_encode": _time_f2_at(ENCODE_TOKENS, keep_sum=False)},
            {"name": "add_layer_norm backward (F2)", **common,
             "launches": backward_launches,
             "launches_by_variant": by_variant.get("add_layer_norm backward", {}),
             **_time_f2_backward_at(W5M_TOKENS, 8),
             "at_drop32": _time_f2_backward_at(W5M_TOKENS, 32),
             "at_no_dropout": _time_f2_backward_at(W5M_TOKENS)}]


def _time_site_dropout_at(rows: int, nbits: int) -> dict:
    """The site kernel at (rows, 768) bf16 (the W5M step's embedding output)
    against the plain dropout (the plain generator's mask, then where) and
    F.dropout (torch's own generator: the same work, another mask)."""
    bf = torch.bfloat16
    x = torch.randn((rows, BERT_H), generator=torch.Generator(device="cuda")
                    .manual_seed(54), device="cuda").to(bf)
    drop = (11, 0.1, nbits, None)
    kernel = lambda: fused_layer._site_dropout_kernel(x, drop)  # noqa: E731
    plain = lambda: fused_layer.site_dropout_plain(x, drop)  # noqa: E731
    got, want = kernel(), plain()
    require(torch.equal(got, want), f"site dropout at {rows}, {nbits} bits: "
                                    "differs from the plain version")
    err = (got.float() - want.float()).abs().max().item()
    del got, want
    ms = cuda_ms(kernel, reps=20, warmup=3)
    plain_ms = cuda_ms(plain, reps=3)
    library_ms = cuda_ms(lambda: torch.nn.functional.dropout(x, 0.1, training=True),
                         reps=20, warmup=3)
    n = x.numel()
    del x
    torch.cuda.empty_cache()
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            **_bound(4.0 * n, (1.0 + _philox_ops(nbits)) * n),
            "library_ms": library_ms, "library_covers":
                "F.dropout (torch's generator: the same work, another mask)",
            "shape": f"{rows:,} x {BERT_H} bf16 drop {nbits}"}


def time_site_dropout(launches: int, by_variant: dict) -> dict:
    """The site kernel at the W5M train step's embedding output (131,072 x
    768), 32-bit masks (phase 6's) and 8-bit ones (`at_drop8`)."""
    return {"name": "site_dropout (the embedding output)", "route": "cuda",
            "source": "blp_tpu_torch/csrc/fused_layer.cu",
            "replaces": "blp_tpu/models/bert.py:208",
            "xla_fusion": "no Pallas kernel: XLA fuses _rng_dropout's compare, "
                          "scale and select (:208-221) into its consumers; the "
                          "bits come from a separate rng-bit-generator op",
            "launches": launches,
            "launches_by_variant": by_variant.get("site_dropout", {}),
            **_time_site_dropout_at(W5M_TOKENS, 32),
            "at_drop8": _time_site_dropout_at(W5M_TOKENS, 8)}


def _time_row_gather_at(config: str) -> dict:
    """The word tables' gather backward at a train cell's W5M step (131,072
    positions drawn as the benchmark's w5m-train traffic draws them: ~9% on
    the padding row, Zipf words): `segment_sum` held bit-equal to
    `segment_sum_plain`, to itself on a second call, and to the f32
    summation bound of a float64 sum (tests/test_torch_cuda.py's). `ms` is
    `index_put_segsum` alone, device time by the profiler; by CUDA events,
    `with_sort_ms` the whole call (zero fills, the ids' cast, the sort, the
    kernel) and, in turns with it, `library_ms` torch's index backward (zero
    fill, sort, indexing_backward_kernel), what the port ran before;
    `embedding_backward_ms` aten.embedding_dense_backward, the library's own
    segmented sum, on the same ids; `plain_ms`."""
    ids, rows, width = word_grad_probe.cell_ids(config)
    g = torch.randn(tuple(ids.shape) + (width,), device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(55))
    call = lambda: row_gather.segment_sum(g, ids, rows)  # noqa: E731
    got = call()
    require(torch.equal(got, row_gather.segment_sum_plain(g, ids, rows)),
            f"index_put_segsum at {config}'s ids differs from the plain version")
    require(torch.equal(got, call()), f"index_put_segsum at {config}'s ids: "
                                      "two calls differ")
    flat, g64 = ids.reshape(-1), g.reshape(-1, width).double()
    exact = torch.zeros((rows, width), dtype=torch.float64, device="cuda")
    exact.index_add_(0, flat, g64)
    mass = torch.zeros_like(exact).index_add_(0, flat, g64.abs())
    counts = torch.bincount(flat, minlength=rows)
    chain = row_gather.CHUNK + 1 + (counts + row_gather.CHUNK - 1) // row_gather.CHUNK
    gap = (got.double() - exact).abs()
    require(bool((gap <= chain[:, None].double() * 2.0 ** -24 * mass).all())
            and bool((got[counts == 0] == 0).all()),
            f"index_put_segsum at {config}'s ids: outside the f32 summation bound")
    err, touched = gap.max().item(), int((counts > 0).sum())
    del got, exact, mass, gap, g64
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(20):
            call()
        torch.cuda.synchronize()
    # The mean over the launches the profiler kept: late in this script it
    # can drop some of a loop's events, which a division by the calls
    # would read as a faster kernel.
    kept = [e for e in prof.key_averages() if "index_put_segsum" in e.key]
    ms = sum(e.self_device_time_total for e in kept) / sum(e.count for e in kept) / 1e3
    table = torch.zeros((rows, width), device="cuda", requires_grad=True)
    gathered = table[ids]
    with_sort_ms, library_ms = cuda_ms_in_turns(
        call, lambda: torch.autograd.grad(gathered, table, g, retain_graph=True))
    embedding_backward_ms = cuda_ms(
        lambda: torch.ops.aten.embedding_dense_backward(g, ids, rows, -1, False),
        reps=20, warmup=3)
    plain_ms = cuda_ms(lambda: row_gather.segment_sum_plain(g, ids, rows), reps=2)
    del table, gathered, g
    torch.cuda.empty_cache()
    return {"max_abs_err": err, "ms": ms, "with_sort_ms": with_sort_ms,
            "plain_ms": plain_ms,
            # g read once, each touched row written once.
            **_bound(4.0 * (flat.numel() + touched) * width, 0.0),
            "library_ms": library_ms, "library_covers":
                "torch's index backward: zero fill, sort, indexing_backward_kernel",
            "embedding_backward_ms": embedding_backward_ms,
            "shape": f"{flat.numel():,} positions x {width} f32 over {rows:,} rows "
                     f"({config}'s ids, {touched:,} rows touched)"}


def time_row_gather(launches: int) -> dict:
    """The word tables' gather backward at glove-dkrl's W5M step (131,072 x
    300 over 400,001 rows) and, under `at_w768`, blp-bert-base's (131,072 x
    768 over 28,996)."""
    return {"name": "index_put_segsum (word-table backward)", "route": "cuda",
            "source": "blp_tpu_torch/csrc/row_gather.cu",
            "replaces": "no Pallas kernel: XLA does the VJP's scatter-add of the "
                        "word tables' gather (blp_tpu/models/encoders.py, bert.py)",
            "launches": launches,
            **_time_row_gather_at("glove-dkrl"),
            "at_w768": _time_row_gather_at("blp-bert-base")}


def _f3_bias_bytes(bias) -> float:
    """Bytes of the bias the kernel reads: each distinct f32 element once."""
    return 4.0 * math.prod(n for n, st in zip(bias.shape, bias.stride()) if st)


def _philox_ops(nbits) -> float:
    """The dropout generator's operations an element (csrc/dropout_rng.cuh):
    a Philox call's 10 rounds of two mulhi, two mullo, four xors and two key
    adds shared by the call's masks, then a shift, mask and compare; 0
    without dropout."""
    if nbits is None:
        return 0.0
    return 100.0 / dropout_rng.MASKS_PER_CALL[nbits] + 3.0


def _time_f3_at(rows: int, seg, round_logits: bool, nbits) -> dict:
    """F3's forward at (rows, 12, 128, 128) bf16 -> bf16 (its mask evaluated
    in the kernel) through the design the wrapper picks and, a yardstick,
    the row design (`row_ms`; the two in turns, `cuda_ms_in_turns`), and the
    plain chain (the plain generator's mask; CUDA events), torch.softmax on
    the f32 scaled, biased logits (the library's nearest call), the bound
    (l, y and the bias once; the operations with the generator's)."""
    bf, scale = torch.bfloat16, math.sqrt(ATTN_HD)
    l, bias, _ = f3_inputs(rows, seg, bf, bf, seed=60)
    drop = _dropout(nbits, 7)
    which = attn_softmax.design(l, bias.expand(l.shape), l, round_logits=round_logits,
                                dropout=drop)
    kernel = lambda kind=None: attn_softmax._forward_kernel(  # noqa: E731
        l, bias, scale, bf, round_logits, drop, kind)
    plain = lambda: attn_softmax.attn_softmax_plain(l, bias, scale, bf,  # noqa: E731
                                                    round_logits, drop)
    with torch.no_grad():
        ok, err = f_close(kernel(), plain(), rows_summed=True,
                          ulps=1 if drop is None else 2)
        require(ok, f"F3 at {rows} rows: error {err}")
        ms, row_ms = cuda_ms_in_turns(kernel, lambda: kernel("row"))
        plain_ms = cuda_ms(plain, reps=3)
        x = l.float() / scale + bias
        library_ms = cuda_ms(lambda: torch.softmax(x, dim=-1), reps=10, warmup=2)
    n = l.numel()
    nbytes = 4.0 * n + _f3_bias_bytes(bias)
    del l, bias, x
    torch.cuda.empty_cache()
    kind = "round" if round_logits else f"drop {nbits}"
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "row_ms": row_ms,
            "design": which, **_bound(nbytes, (F3_OPS + _philox_ops(nbits)) * n),
            "library_ms": library_ms,
            "library_covers": "torch.softmax on the f32 scaled, biased logits: "
                              "no scale, bias, cast or dropout",
            "shape": f"{rows:,} x {ATTN_HEADS} x {ATTN_SP} x {ATTN_SP} bf16->bf16 "
                     f"{kind}, seg {seg}"}


def _time_f3_backward_at(rows: int, seg, nbits) -> dict:
    """F3's backward kernel (its mask evaluated again in the kernel; the row
    design's time beside it as for the forward) against the plain chain's
    VJP (forward and backward, as autograd runs it from l, with the plain
    generator's mask) and aten._softmax_backward_data on f32 y and g (the
    library's nearest call)."""
    bf, scale = torch.bfloat16, math.sqrt(ATTN_HD)
    l, bias, gy = f3_inputs(rows, seg, bf, bf, seed=61)
    drop = _dropout(nbits, 8)

    def plain_vjp():
        with torch.enable_grad():
            ll = l.detach().requires_grad_()
            return torch.autograd.grad(attn_softmax.attn_softmax_plain(
                ll, bias, scale, bf, False, drop), ll, gy)[0]

    which = attn_softmax.design(l, bias.expand(l.shape), l, gy)
    kernel = lambda kind=None: attn_softmax._backward_kernel(  # noqa: E731
        gy, l, bias, scale, drop, kind)
    ok, err = f_close(kernel(), plain_vjp(), rows_summed=True)
    require(ok, f"F3 backward at {rows} rows: dl error {err}")
    ms, row_ms = cuda_ms_in_turns(kernel, lambda: kernel("row"))
    plain_ms = cuda_ms(plain_vjp, reps=3)
    with torch.no_grad():
        y32 = torch.softmax(l.float() / scale + bias, dim=-1)
        g32 = gy.float()
    library_ms = cuda_ms(lambda: torch.ops.aten._softmax_backward_data(
        g32, y32, -1, torch.float32), reps=10, warmup=2)
    n = l.numel()
    nbytes = 6.0 * n + _f3_bias_bytes(bias)    # l, g, dl; bias
    del l, bias, gy, y32, g32
    torch.cuda.empty_cache()
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "row_ms": row_ms,
            "design": which, **_bound(nbytes, (F3_BWD_OPS + _philox_ops(nbits)) * n),
            "library_ms": library_ms,
            "library_covers": "aten._softmax_backward_data on f32 y and g: the "
                              "softmax's backward alone, no recompute, dropout or "
                              "casts",
            "shape": f"{rows:,} x {ATTN_HEADS} x {ATTN_SP} x {ATTN_SP} bf16->bf16 "
                     f"drop {nbits}, seg {seg}"}


def time_f3(launches: int, backward_launches: int, by_variant: dict) -> list[dict]:
    """F3 at the W5M train step's shape (1,024 rows of two 64-token
    segments, 8-bit masks as bench --w5m takes them; 32-bit ones, phase 6's,
    under `at_drop32`; none under `at_no_dropout`, so the gap shows what the
    generator costs) and, its inference variant, at the W5M encode chunk
    (6,144 rows, `at_encode`) and at L 32 (1,024 rows of four segments,
    `at_l32`)."""
    common = {"route": "cuda", "source": "blp_tpu_torch/csrc/attn_softmax.cu",
              "replaces": "blp_tpu/models/bert.py:430",
              "xla_fusion": "no Pallas kernel: XLA fuses the scale, mask bias, "
                            "jax.nn.softmax, bf16 cast and _rng_dropout "
                            "(:430-441; the inference layer's :357-365)"}
    fwd = {"name": "attn_softmax (F3)", **common, "launches": launches,
           "launches_by_variant": by_variant.get("attn_softmax", {}),
           **_time_f3_at(1024, W5M_SEG, False, 8),
           "at_drop32": _time_f3_at(1024, W5M_SEG, False, 32),
           "at_no_dropout": _time_f3_at(1024, W5M_SEG, False, None),
           "at_encode": _time_f3_at(W5M_K2_ROWS, W5M_SEG, True, None),
           "at_l32": _time_f3_at(1024, SEG, True, None)}
    bwd = {"name": "attn_softmax backward (F3)", **common,
           "launches": backward_launches,
           "launches_by_variant": by_variant.get("attn_softmax backward", {}),
           **_time_f3_backward_at(1024, W5M_SEG, 8),
           "at_drop32": _time_f3_backward_at(1024, W5M_SEG, 32),
           "at_no_dropout": _time_f3_backward_at(1024, W5M_SEG, None)}
    return [fwd, bwd]


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

    # The native packer, which every data load below uses, builds here.
    t0 = time.perf_counter()
    built_before = native.library_path().exists()
    require(native.available(),
            f"the native packer did not build: {native.build_error}")
    native_build_s = time.perf_counter() - t0
    how = "loaded (built before)" if built_before else "built (g++) and loaded"
    log(f"native packer: {how} in {native_build_s:.2f} s "
        f"({native.library_path().name})")

    check_k1()
    check_k2()
    check_k3()
    check_f2_one_launch()

    shutil.rmtree(WORK_DIR, ignore_errors=True)
    data_dir = write_synth_dataset(os.path.join(WORK_DIR, "synth4096"),
                                   num_entities=4096, num_relations=12,
                                   num_triples=8000, seed=0)
    cfg, params = make_model(num_relations=12)

    reset_counts()
    serve_stats = serve_phase(data_dir, cfg, params)
    eval_stats = eval_phase(data_dir, cfg, params)
    infer_launches = read_counts()
    log(f"main-path launches, inference (phases 4-5): {infer_launches}")
    del params
    torch.cuda.empty_cache()

    reset_counts()
    train_stats = train_phase(data_dir, card)
    train_launches = read_counts()
    log(f"main-path launches, train (phase 6): {train_launches}")
    torch.cuda.empty_cache()

    reset_counts()
    word_stats = word_phase(data_dir)
    word_launches = read_counts()
    log(f"main-path launches, word models (phase 8): {word_launches}")
    require(all(word_launches[k] > 0 for k in ("K1", "K3", "K3 backward")),
            "a kernel of the word models' path was never launched")
    torch.cuda.empty_cache()

    reset_counts()
    mesh_stats, mesh_launches = mesh_phase(data_dir, cfg, read_counts)
    log(f"main-path launches, multi-device paths (phase 9): {mesh_launches}")
    require(all(mesh_launches.get(k, 0) > 0 for k in COUNTERS),
            "a kernel of the multi-device paths was never launched")
    torch.cuda.empty_cache()

    reset_counts()
    done_stats = completion_phase(data_dir, card, read_counts, native_build_s)
    done_launches = read_counts()
    log(f"main-path launches, the completing modules (phase 10): {done_launches}")
    require(all(done_launches[k] > 0 for k in COUNTERS),
            "a kernel of phase 10's paths was never launched")
    torch.cuda.empty_cache()

    reset_counts()
    w5m_stats = w5m_phase(read_counts)
    w5m_launches = read_counts()
    log(f"main-path launches, the Wikidata5M mode (phase 11): {w5m_launches}")
    require(all(w5m_launches[k] > 0 for k in COUNTERS)
            and w5m_launches["K2 by seg"][W5M_SEG] > 0,
            "a kernel of phase 11's paths was never launched")
    torch.cuda.empty_cache()

    reset_counts()
    bench_stats = bench_phase(read_counts)
    bench_launches = read_counts()
    log(f"main-path launches, the measurement entry points (phase 12): "
        f"{bench_launches}")
    require(bench_launches["K1"] > 0,
            "K1 was never launched by phase 12's entry points")
    torch.cuda.empty_cache()

    # reset inside: (a) holds the kernels to their plain versions first
    fused_stats, fused_launches = fused_phase(train_stats["w5m_train_peak_bytes"])
    log(f"main-path launches, the fused chains (phase 13): {fused_launches}")
    require(all(fused_launches[k] > 0 for k in COUNTERS if k[0] == "F"),
            "F1, F2 or F3 was never launched by phase 13's paths")
    torch.cuda.empty_cache()

    # reset inside: (a) holds F3 to its plain version first
    softmax_stats, softmax_launches = softmax_phase(data_dir, card)
    log(f"main-path launches, the attention softmax chain (phase 14): "
        f"{softmax_launches}")
    torch.cuda.empty_cache()

    # reset inside: (a) holds the masks to the plain generator first
    dropout_stats, dropout_launches = dropout_phase(data_dir)
    log(f"main-path launches, the dropout masks in the kernels (phase 15): "
        f"{dropout_launches}")
    phases = (infer_launches, train_launches, word_launches, mesh_launches,
              done_launches, w5m_launches, bench_launches, fused_launches,
              softmax_launches, dropout_launches)
    launches = {k: sum(p[k] for p in phases) for k in COUNTERS}
    k1_counts = sum((p["K1 by variant"] for p in phases), collections.Counter())
    k1_by = {v: {d: c for (w, d), c in sorted(k1_counts.items()) if w == v}
             for v in transe_rank.VARIANTS}   # {variant: {d: launches}}
    k2_by = dict(sorted(sum((p["K2 by seg"] for p in phases),
                            collections.Counter()).items()))
    f_counts = sum((p["F by variant"] for p in phases), collections.Counter())
    f_by = {}                 # {kernel: {variant: launches}}
    for (kernel, variant), c in sorted(f_counts.items()):
        f_by.setdefault(kernel, {})[variant] = c
    log(f"main-path launches: {launches}; K1 by variant and width: {k1_by}; "
        f"K2 by segment length: {k2_by}; F1, F2 and F3 by variant: {f_by}")
    require(all(n > 0 for n in launches.values()),
            "a kernel of the main path was never launched")
    require(all(k1_by["tma"].get(d, 0) > 0 for d in (K1_D, *WORD_DIMS))
            and not k1_by["scalar"],
            "a main-path K1 launch at d 128, 300 or 768 did not take the tma variant")
    require(sum(k2_by.values()) == launches["K2"] and set(k2_by) == set(K2_SEGS),
            f"K2's launches by segment length {k2_by} do not cover seg 32 and 64")
    require(any(v.endswith(" heads") for v in f_by.get("bias_act", {}))
            and all(any(v.endswith(f" {lay}") for v in f_by.get("bias_act backward", {}))
                    for lay in ("heads", "heads_t")),
            "the main path's q, k and v did not take F1's head-major layouts: "
            f"{f_by.get('bias_act')}, {f_by.get('bias_act backward')}")
    f3_row = {f"{name}: {v}": c for name in ("attn_softmax", "attn_softmax backward")
              for v, c in f_by.get(name, {}).items()
              if v.endswith(f" sk{ATTN_SP}") and not v.startswith("tile ")}
    require(not f3_row, "main-path F3 launches at Sk 128 did not take the tile "
            f"design: {f3_row}")
    f2_other = {v: c for v, c in f_by.get("add_layer_norm", {}).items()
                if v.endswith(f" w{BERT_H}") and not v.startswith("slab ")}
    require(f_by.get("add_layer_norm") and not f2_other,
            f"main-path F2 forward launches at H {BERT_H} did not take the slab "
            f"design: {f2_other}")
    torch.cuda.empty_cache()

    kernels = [time_k1(launches["K1"], k1_by), time_k2(launches["K2"], k2_by),
               *time_k3(launches["K3"], launches["K3 backward"]),
               *time_f1(launches["F1"], launches["F1 backward"], f_by),
               *time_f2(launches["F2"], launches["F2 backward"], f_by),
               *time_f3(launches["F3"], launches["F3 backward"], f_by),
               time_site_dropout(launches["site dropout"], f_by),
               time_row_gather(launches["word-table backward"])]
    for kr in kernels:
        for rec in (kr, *(v for k, v in kr.items() if k.startswith("at_"))):
            log(f"{kr['name']}: {rec['ms']:.4f} ms (plain "
                f"{rec['plain_ms']:.4f} ms, library "
                f"{rec.get('library_ms', kr['library_ms'])}, "
                f"bound {rec['bound_ms']:.5f} ms by {rec['bound_by']}, "
                f"{100 * rec['bound_ms'] / rec['ms']:.1f}% of it) at "
                f"{rec['shape']}")
            if "row_ms" in rec:
                log(f"  {rec['design']} design; the row design {rec['row_ms']:.4f} ms "
                    f"({100 * rec['bound_ms'] / rec['row_ms']:.1f}% of the bound)")
            if "scalar_ms" in rec:
                log(f"  its scalar variant {rec['scalar_ms']:.4f} ms "
                    f"({100 * rec['bound_ms'] / rec['scalar_ms']:.1f}% of the bound); "
                    f"SM clock, max right after: {rec['sm_clock']}")
            if "kernel_ms" in rec:
                log(f"  of which the kernel {rec['kernel_ms']:.4f} ms; "
                    f"{rec['launches_per_call']:g} device launches per call "
                    f"(plain VJP: {rec['plain_launches_per_call']:g})")
        if "call_ms" in kr:
            log(f"{kr['name']}: device time per call above; per call with "
                f"the host's launch path {kr['call_ms']:.4f} ms (B=64), "
                f"{kr['at_b1024']['call_ms']:.4f} ms (B=1024)")
    log("summary: " + json.dumps({**serve_stats, **eval_stats, **train_stats,
                                  **word_stats, **mesh_stats, **done_stats,
                                  **w5m_stats, **bench_stats, **fused_stats,
                                  **softmax_stats, **dropout_stats},
                                 default=str))
    shutil.rmtree(WORK_DIR, ignore_errors=True)
    print(card)   # name, power limit: nvidia-smi's own line
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
