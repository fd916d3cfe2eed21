"""Training step construction: Adam with a linear-warmup schedule, and the
train step (port of blp_tpu/training.py).

Adam is a small function over the parameter tree with optax's semantics and
optax's state shape, ((count, mu, nu), (sched_count,)) with the schedule and
((count, mu, nu), ()) without, so a state file written by either package
resumes in the other (checkpoint.py flattens in JAX's order):

- mu = (1 - b1) g + b1 mu, nu = (1 - b2) g² + b2 nu, count += 1;
- update = (mu / (1 - b1^count)) / (sqrt(nu / (1 - b2^count)) + eps), with
  eps = 1e-8 outside the square root;
- the scheduled learning rate is read at the schedule's count BEFORE its
  increment, so with warmup step 0 has lr 0 and moves nothing;
- `bf16_mu` stores the first moment in bfloat16; the update is computed
  from the f32 value of (1 - b1) g + b1 mu before that cast, where b1 mu is
  a bf16 product with b1 rounded to bf16, as JAX's weak typing of the
  Python scalar makes it; nu stays f32.

The updates use `torch._foreach_*` over the leaves. The functions are
functional (they return new tensors and leave their arguments as they
were), like optax's. The step samples the negatives on the device, so a
step enqueues its work and returns a 0-d device loss without a host sync.
Its spans (`profiling.span`): `train.sample` (the negatives),
`train.forward`, `train.backward` and `train.optimizer` (Adam's update and
`apply_updates`).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from blp_tpu_torch.checkpoint import tree_leaves, tree_unflatten
from blp_tpu_torch.data.sampling import sample_negative_indices
from blp_tpu_torch.models import bert as bert_mod
from blp_tpu_torch.models import blp
from blp_tpu_torch.profiling import span
from blp_tpu_torch.utils import fold_seed, resolve_device


def linear_warmup_schedule(lr: float, total_steps: int, warmup_frac: float = 0.2):
    """HF get_linear_schedule_with_warmup semantics: lr * step/warmup during
    warmup, then linear decay to 0 at total_steps. step -> 0-d float32."""
    warmup = int(warmup_frac * total_steps)

    def schedule(step):
        step = torch.as_tensor(step).to(torch.float32)
        w = max(warmup, 1)
        t = max(total_steps - warmup, 1)
        warm = step / w
        decay = torch.clamp((total_steps - step) / t, min=0.0)
        return lr * torch.where(step < warmup, warm, decay)

    return schedule


B1, B2, EPS = 0.9, 0.999, 1e-8


@dataclasses.dataclass(frozen=True)
class Adam:
    """optax.adam(learning_rate, b1=0.9, b2=0.999, eps=1e-8, mu_dtype) over
    a tree of tensors; `learning_rate` is a float or a schedule of the step
    count."""

    learning_rate: float | Callable
    mu_dtype: Any = None

    def init(self, params):
        leaves = tree_leaves(params)
        dev = leaves[0].device
        mu = tree_unflatten(params, [torch.zeros_like(p, dtype=self.mu_dtype)
                                     for p in leaves])
        nu = tree_unflatten(params, [torch.zeros_like(p) for p in leaves])
        count = torch.zeros((), dtype=torch.int32, device=dev)
        sched = ((torch.zeros((), dtype=torch.int32, device=dev),)
                 if callable(self.learning_rate) else ())
        return ((count, mu, nu), sched)

    def update(self, grads, state, params=None):
        """(updates, new_state) for `grads`; `params` is unused (optax's
        signature)."""
        del params
        (count, mu, nu), sched = state
        g = tree_leaves(grads)
        m_old, v_old = tree_leaves(mu), tree_leaves(nu)
        b1, b2 = B1, B2
        # (1 - b1) g + b1 mu in f32. With a bf16 mu, b1 mu is a bf16 product
        # with b1 rounded to bf16 (JAX's weak typing of the python scalar).
        b1_mu = b1 if self.mu_dtype is None else float(
            torch.tensor(b1).to(self.mu_dtype))
        m = torch._foreach_mul(g, 1.0 - b1)
        torch._foreach_add_(m, [x.float() for x in
                                torch._foreach_mul(m_old, b1_mu)])
        v = torch._foreach_mul(torch._foreach_mul(g, g), 1.0 - b2)
        torch._foreach_add_(v, torch._foreach_mul(v_old, b2))
        count = count + 1
        step = count.to(torch.float32)
        m_hat = torch._foreach_div(m, 1.0 - b1 ** step)
        v_hat = torch._foreach_div(v, 1.0 - b2 ** step)
        denom = torch._foreach_sqrt(v_hat)
        torch._foreach_add_(denom, EPS)
        upd = torch._foreach_div(m_hat, denom)
        if callable(self.learning_rate):
            (sched_count,) = sched
            torch._foreach_mul_(upd, -self.learning_rate(sched_count))
            sched = (sched_count + 1,)
        else:
            torch._foreach_mul_(upd, -self.learning_rate)
        if self.mu_dtype is not None:
            m = [x.to(self.mu_dtype) for x in m]
        new_state = ((count, tree_unflatten(mu, m), tree_unflatten(nu, v)),
                     sched)
        return tree_unflatten(grads, upd), new_state


def apply_updates(params, updates):
    """params + updates, leaf by leaf, in each param's dtype."""
    p = tree_leaves(params)
    new = torch._foreach_add(p, tree_leaves(updates))
    return tree_unflatten(params, [n.to(x.dtype) for n, x in zip(new, p)])


def make_optimizer(lr: float, total_steps: int, use_scheduler: bool = True,
                   *, bf16_mu: bool = False) -> Adam:
    """Adam at `lr`, eps 1e-8, with the linear warmup schedule when
    `use_scheduler`; bf16_mu stores the first moment in bfloat16 (the TPU
    package's `adam_bf16_mu`). Storing both moments in bf16 is a recorded
    quality failure and is not offered."""
    sched = linear_warmup_schedule(lr, total_steps) if use_scheduler else lr
    return Adam(sched, mu_dtype=torch.bfloat16 if bf16_mu else None)


def unstack_params(params: dict) -> dict:
    """BERT layers unstacked into per-layer leaves (the training layout);
    no-op for non-BERT models or an unstacked tree."""
    if "bert" not in params:
        return params
    out = dict(params)
    out["bert"] = bert_mod.unstack_layers(params["bert"])
    return out


def restack_params(params: dict) -> dict:
    """Inverse of unstack_params (the stored, canonical layout)."""
    if "bert" not in params:
        return params
    out = dict(params)
    out["bert"] = bert_mod.restack_layers(params["bert"])
    return out


def map_param_trees(fn, tree):
    """Apply `fn` to every params-style dict (one holding a 'bert' subtree)
    inside a container tree: converts the param-mirroring mu/nu of an
    optimizer state between the stacked and unstacked layouts."""
    def rec(node):
        if isinstance(node, dict):
            if "bert" in node:
                return fn(node)
            return {k: rec(v) for k, v in node.items()}
        if isinstance(node, (tuple, list)):
            return type(node)(rec(v) for v in node)
        return node
    return rec(tree)


def restack_opt_state(opt_state):
    return map_param_trees(restack_params, opt_state)


def unstack_opt_state(opt_state):
    return map_param_trees(unstack_params, opt_state)


def value_and_grad(params, cfg: blp.ModelConfig, batch: dict, *,
                   dropout_seed: int):
    """(loss, grads) of the training pass of blp.train_loss at `params`:
    the loss a 0-d device tensor, the gradients a tree shaped like `params`
    (zeros for leaves the loss does not reach, as jax.grad gives)."""
    leaves = tree_leaves(params)
    with span("train.forward"):
        live = [p.detach().requires_grad_() for p in leaves]
        loss = blp.train_loss(tree_unflatten(params, live), cfg, batch,
                              deterministic=False, dropout_seed=dropout_seed)
    with span("train.backward"):
        grads = torch.autograd.grad(loss, live, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(leaves, grads)]
    return loss.detach(), tree_unflatten(params, grads)


def step_seeds(key) -> tuple[int, int]:
    """(negative-sampler seed, dropout seed) of a step key: an int, or a
    (base seed, global step) pair folded together."""
    seed = fold_seed(*key) if isinstance(key, tuple) else int(key)
    return fold_seed(seed, 0), fold_seed(seed, 1)


def make_train_step(cfg: blp.ModelConfig, optimizer: Adam, *, batch_size: int,
                    num_negatives: int, device=None) -> Callable:
    """Build the train step on `device` (default cuda).

    step(params, opt_state, key, batch) -> (params, opt_state, loss)

    batch: tensors on the device; text models {text_tok (B,2,L), text_mask,
    rels}, transductive {pos_pairs, rels}. `key` is a seed or a (seed,
    global_step) pair; the negatives (from a generator on the device) and
    the dropout masks derive from it. `loss` stays a 0-d device tensor.
    """
    dev = resolve_device(device)

    def step(params, opt_state, key, batch):
        neg_seed, drop_seed = step_seeds(key)
        with span("train.sample"):
            gen = torch.Generator(device=dev).manual_seed(neg_seed)
            batch = dict(batch)
            batch["neg_idx"] = sample_negative_indices(gen, batch_size,
                                                       num_negatives, dev)
        loss, grads = value_and_grad(params, cfg, batch, dropout_seed=drop_seed)
        with span("train.optimizer"):
            updates, opt_state = optimizer.update(grads, opt_state, params)
            params = apply_updates(params, updates)
        return params, opt_state, loss

    return step
