"""The plain reference's shared parts: seeds, the negatives' draw, the
TransE scores and margin loss, Adam with its schedule, the products in a
stated precision, and the rank counts of the filtered evaluation.

Plain PyTorch, written from the published definitions and the port's
documented contracts (the seed derivation, the negatives' draw and the
fixed add order of the rank distances), never from its code: nothing here
imports the port.
"""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch

_MASK64 = (1 << 64) - 1
B1, B2, EPS = 0.9, 0.999, 1e-8
#: The rank distance's chunk: a chain of adds over each 32 dims, then a
#: chain over the chunks (the order the port's rank kernel documents).
RANK_CHUNK = 32
#: The precisions a reference product runs in: the configuration's own, and
#: the controls one step below it.
PRECISIONS = ("fp32", "tf32", "bf16", "fp8")


def fold_seed(seed: int, data: int) -> int:
    """A 63-bit seed from `seed` and `data`: the splitmix64 finalizer over
    seed * golden + data + constant, shifted right by one."""
    z = (int(seed) * 0x9E3779B97F4A7C15 + int(data) + 0x632BE59BD9B4E019) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return (z ^ (z >> 31)) >> 1


def step_seeds(base: int, step: int) -> tuple[int, int]:
    """(negatives seed, dropout seed) of the train step keyed (base, step)."""
    seed = fold_seed(base, step)
    return fold_seed(seed, 0), fold_seed(seed, 1)


def negatives(seed: int, batch: int, k: int, device) -> torch.Tensor:
    """(B, K, 2) slot indices of the in-batch negatives: r ~ U[0, 2B-2) and
    a fair coin from one torch generator on `device` seeded `seed`; the
    corrupted slot is r shifted past the row's own pair, the other slot is
    the row's own."""
    gen = torch.Generator(device=device).manual_seed(seed)
    r = torch.randint(0, 2 * batch - 2, (batch, k), generator=gen,
                      device=device, dtype=torch.int32).long()
    coin = torch.rand((batch, k), generator=gen, device=device) < 0.5
    row = torch.arange(batch, device=device)[:, None]
    other = r + 2 * (r >= 2 * row).long()
    head = torch.where(coin, other, 2 * row)
    tail = torch.where(coin, 2 * row + 1, other)
    return torch.stack([head, tail], dim=-1)


@contextlib.contextmanager
def precision(mode: str):
    """Products inside run in `mode`: "fp32" and "fp8" with TF32 off (fp8
    rounds the operands in `mm`), "tf32" with it on; "bf16" rounds the
    operands in `mm` with TF32 off."""
    if mode not in PRECISIONS:
        raise ValueError(f"precision {mode!r}: expected one of {PRECISIONS}")
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    tf32 = mode == "tf32"
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


#: fp8 formats of an fp8 step: e4m3 for the forward's operands, e5m2 for
#: the gradients, each with one scale a tensor (its largest magnitude at the
#: format's largest finite value).
FP8 = {"e4m3": (torch.float8_e4m3fn, 448.0), "e5m2": (torch.float8_e5m2, 57344.0)}


def fp8(x: torch.Tensor, fmt: str = "e4m3") -> torch.Tensor:
    dtype, top = FP8[fmt]
    scale = x.abs().amax().clamp(min=1e-30) / top
    return (x / scale).to(dtype).to(torch.float32) * scale


def round_to(x: torch.Tensor, mode: str) -> torch.Tensor:
    """x as the operand of a product in `mode`: itself in fp32 and tf32
    (the library rounds tf32), rounded to bf16, or to fp8 e4m3 (`fp8`),
    back in fp32."""
    if mode in ("fp32", "tf32"):
        return x
    if mode == "bf16":
        return x.to(torch.bfloat16).to(torch.float32)
    return fp8(x)


def _sum_to(x: torch.Tensor, shape) -> torch.Tensor:
    """x summed over the leading dimensions that broadcasting added."""
    while x.dim() > len(shape):
        x = x.sum(0)
    return x


class _Fp8Matmul(torch.autograd.Function):
    """a @ b as an fp8 step computes it: e4m3 operands forward, and in the
    backward the incoming gradient in e5m2 against the same e4m3 operands."""

    @staticmethod
    def forward(ctx, a, b):
        qa, qb = fp8(a), fp8(b)
        ctx.save_for_backward(qa, qb)
        ctx.shapes = a.shape, b.shape
        return torch.matmul(qa, qb)

    @staticmethod
    def backward(ctx, g):
        qa, qb = ctx.saved_tensors
        qg = fp8(g, "e5m2")
        sa, sb = ctx.shapes
        return (_sum_to(torch.matmul(qg, qb.transpose(-1, -2)), sa),
                _sum_to(torch.matmul(qa.transpose(-1, -2), qg), sb))


def mm(a: torch.Tensor, b: torch.Tensor, mode: str) -> torch.Tensor:
    """a @ b in `mode`: with the operands as `round_to` rounds them, or in
    fp8 forward and backward."""
    if mode == "fp8":
        return _Fp8Matmul.apply(a, b)
    return torch.matmul(round_to(a, mode), round_to(b, mode))


def l2_normalize(x: torch.Tensor) -> torch.Tensor:
    return x / x.norm(dim=-1, keepdim=True).clamp(min=1e-12)


def transe_margin_loss(ent: torch.Tensor, rel: torch.Tensor,
                       neg: torch.Tensor, regularizer: float,
                       margin: float = 1.0) -> torch.Tensor:
    """BLP's loss of a batch: ent (B, 2, d) normalized head and tail rows,
    rel (B, d), neg (B, K, 2) slots of the flattened (2B, d) rows. TransE
    scores -|h + r - t|_1, mean(relu(margin - pos + neg)), plus the
    regularizer times the mean of the three tensors' mean squares."""
    h, t = ent[:, 0], ent[:, 1]
    pos = -(h + rel - t).abs().sum(-1)[:, None]
    flat = ent.reshape(-1, ent.shape[-1])
    nh, nt = flat[neg[..., 0]], flat[neg[..., 1]]
    negs = -(nh + rel[:, None] - nt).abs().sum(-1)
    loss = torch.relu(margin - pos + negs).mean()
    if regularizer:
        loss = loss + regularizer * (h.square().mean() + t.square().mean()
                                     + rel.square().mean()) / 3.0
    return loss


def schedule(lr: float, total_steps: int, use_scheduler: bool,
             warmup_frac: float):
    """The learning rate of step s: linear warmup over warmup_frac of the
    steps, then linear decay to 0 (read before the step counts), or lr."""
    if not use_scheduler:
        return lambda s: lr
    warmup = int(warmup_frac * total_steps)

    def at(s: int) -> float:
        if s < warmup:
            return lr * s / max(warmup, 1)
        return lr * max(0.0, (total_steps - s) / max(total_steps - warmup, 1))

    return at


class Adam:
    """Adam (b1 0.9, b2 0.999, eps 1e-8 outside the square root) over a
    dict of f32 leaves, with the bias corrections at the step count."""

    def __init__(self, params: dict, lr_at):
        self.lr_at = lr_at
        self.step = 0
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}

    @torch.no_grad()
    def update(self, params: dict, grads: dict) -> dict:
        lr = self.lr_at(self.step)
        self.step += 1
        out = {}
        for k, p in params.items():
            g = grads[k]
            self.m[k] = (1 - B1) * g + B1 * self.m[k]
            self.v[k] = (1 - B2) * g * g + B2 * self.v[k]
            m_hat = self.m[k] / (1 - B1 ** self.step)
            v_hat = self.v[k] / (1 - B2 ** self.step)
            out[k] = p - lr * (m_hat / (v_hat.sqrt() + EPS))
        return out


# -- the rank counts -----------------------------------------------------------


def chained_l1(rows: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """sum_d |rows_d + u_d| in fp32: a chain of adds inside each 32-dim
    chunk, then a chain over the chunks; rows (..., C, d), u (..., 1, d)."""
    terms = (rows + u).abs()
    d = terms.shape[-1]
    if d % RANK_CHUNK:
        terms = torch.nn.functional.pad(terms, (0, RANK_CHUNK - d % RANK_CHUNK))
    acc = None
    for c in range(terms.shape[-1] // RANK_CHUNK):
        part = terms[..., c * RANK_CHUNK]
        for j in range(1, RANK_CHUNK):
            part = part + terms[..., c * RANK_CHUNK + j]
        acc = part if acc is None else acc + part
    return acc


def rank_counts(table: torch.Tensor, head: torch.Tensor, tail: torch.Tensor,
                rel: torch.Tensor, head_filter: torch.Tensor,
                tail_filter: torch.Tensor, num_valid: int, *,
                mode: str = "fp32", block: int = 8192) -> dict:
    """Both directions' tie-aware counts of a batch of B triples against
    the first `num_valid` rows of `table`: for the head corruption the
    offset u = r - t, for the tail corruption u = -(r + h); a candidate's
    distance is `chained_l1`. gt / geq count the candidates other than the
    true one whose distance is below / at most the true one's; fgt / fgeq
    the same among the filter positions (-1 padded). Keys as 'h_gt' ...
    't_fgeq', each (B,) int64. `mode` "bf16" rounds the table and the
    offsets to bf16 first (the control)."""
    def rnd(x):
        return x.to(torch.bfloat16).to(torch.float32) if mode == "bf16" else x

    b = head.shape[0]
    head_pos, tail_pos = head, tail
    rows_h, rows_t = table[head_pos], table[tail_pos]
    u = torch.cat([rel - rows_t, -(rel + rows_h)], dim=0)           # (2B, d)
    own = torch.cat([head_pos, tail_pos])
    u = rnd(u)
    pivot = chained_l1(rnd(table[own])[:, None, :], u[:, None, :])  # (2B, 1)
    gt = torch.zeros(2 * b, dtype=torch.int64, device=table.device)
    geq = torch.zeros_like(gt)
    for start in range(0, num_valid, block):
        stop = min(start + block, num_valid)
        dist = chained_l1(rnd(table[start:stop])[None], u[:, None, :])
        cols = torch.arange(start, stop, device=table.device)
        other = cols[None, :] != own[:, None]
        gt += ((dist < pivot) & other).sum(1)
        geq += ((dist <= pivot) & other).sum(1)
    filt = torch.cat([head_filter, tail_filter], dim=0).long()
    present = filt >= 0
    frows = rnd(table[filt.clamp(min=0)])
    fdist = chained_l1(frows, u[:, None, :])
    fgt = ((fdist < pivot) & present).sum(1)
    fgeq = ((fdist <= pivot) & present).sum(1)
    out = {}
    for side, sl in (("h", slice(0, b)), ("t", slice(b, 2 * b))):
        out[f"{side}_gt"], out[f"{side}_geq"] = gt[sl], geq[sl]
        out[f"{side}_fgt"], out[f"{side}_fgeq"] = fgt[sl], fgeq[sl]
    return out


def filters_of(triples: np.ndarray, known: np.ndarray, num_valid: int,
               width: int) -> tuple[np.ndarray, np.ndarray]:
    """The filter positions of each triple [h, t, r]: the other true heads
    of (?, r, t) and the other true tails of (h, r, ?) in `known`, -1
    padded to `width` (entity id = position)."""
    heads_of: dict = {}
    tails_of: dict = {}
    for h, t, r in np.asarray(known, np.int64):
        tails_of.setdefault((h, r), set()).add(t)
        heads_of.setdefault((t, r), set()).add(h)
    hf = np.full((len(triples), width), -1, np.int64)
    tf = np.full((len(triples), width), -1, np.int64)
    for i, (h, t, r) in enumerate(np.asarray(triples, np.int64)):
        hs = sorted(x for x in heads_of.get((t, r), ()) if x != h and x < num_valid)
        ts = sorted(x for x in tails_of.get((h, r), ()) if x != t and x < num_valid)
        hf[i, :len(hs)] = hs[:width]
        tf[i, :len(ts)] = ts[:width]
    return hf, tf


def per_leaf(values: dict, reference: dict, keep=None) -> dict:
    """values[k] over the larger of the reference's norm of leaf k and of
    the median leaf (over the leaves in `keep`, default all): a leaf whose
    reference is all but zero is measured against the median leaf."""
    names = [k for k in reference if keep is None or k in keep]
    median = float(np.median([float(reference[k]) for k in names])) if names else 0.0
    out = {}
    for k in names:
        base = max(float(reference[k]), median)
        out[k] = float(values[k]) / base if base > 0 else (
            0.0 if float(values[k]) == 0 else math.inf)
    return out


def worst_leaf_gap(program: dict, reference: dict,
                   keep=None) -> tuple[float, str]:
    """The widest gap between the program's and the reference's norm of a
    leaf (`per_leaf`), and its leaf."""
    gaps = per_leaf({k: abs(float(program[k]) - float(v)) for k, v in reference.items()},
                    reference, keep)
    which = max(gaps, key=gaps.get)
    return gaps[which], which
