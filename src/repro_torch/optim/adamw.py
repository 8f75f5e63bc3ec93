"""AdamW with global-norm clipping, the cosine schedule, and gradient
compression (``repro.optim.adamw``).

The JAX package's optimizer over a model's named parameters: ``params``
and ``grads`` map the port's parameter names (``layers.3.wq``,
``periods.0.moe.1.w_up``; `repro_torch.models.model`) to tensors, and
the moments and the error-feedback buffer are mappings under the same
names.  ``torch.optim.AdamW`` is not used: its clipping, schedule and
decay are another function.  The arithmetic is the JAX package's: the
schedule and the bias corrections ``1 - b ** step`` are f32 tensors,
moments are kept in ``moments_dtype`` and updated in f32, each parameter
is updated in f32 and rounded back to its type.

Weight decay follows the JAX package's rule, ``ndim >= 2`` of the JAX
leaf.  The JAX package stacks every per-layer parameter on a layer axis
(one for ``layers`` and ``enc_layers`` and a hybrid period's ``attn``,
two for a period's other groups), where the port keeps one tensor per
layer; so a layer's norm weight, its biases and the Mamba vectors, rank
1 here, are rank 2 there and decayed (`jax_rank`).  Only ``final_w`` and
``final_b`` are not.

``compress_grads`` is the bf16 compression with an error-feedback
accumulator: ``g' = bf16(g + err)``, ``err' = (g + err) - g'``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Mapping, NamedTuple, Optional, Tuple

import torch

from repro_torch.distributed.sharding import dtensor_context, is_dtensor

__all__ = ["AdamWConfig", "OptState", "init_opt", "apply_updates",
           "cosine_schedule", "compress_grads", "global_norm", "jax_rank"]

Tensors = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


class OptState(NamedTuple):
    """``step`` an int32 0-d tensor; ``mu``, ``nu`` and ``err`` (None
    without compression) mappings under the parameters' names."""

    step: torch.Tensor
    mu: Tensors
    nu: Tensors
    err: Optional[Tensors]


def _div(a: torch.Tensor, b: float) -> torch.Tensor:
    """``a / b`` in f32 by a true division: PyTorch multiplies a CUDA
    tensor by the reciprocal of a Python divisor (and the CPU divides),
    so the divisor is made a tensor and both devices divide."""
    return a.to(torch.float32) / torch.full((), b, dtype=torch.float32,
                                            device=a.device)


def cosine_schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """The f32 learning rate at ``step`` (an int32 tensor): linear warm-up,
    then a cosine from ``lr`` down to ``min_lr_ratio * lr``."""
    warm = torch.clamp(_div(step + 1, max(1, cfg.warmup_steps)), max=1.0)
    frac = torch.clamp(_div(step - cfg.warmup_steps,
                            max(1, cfg.total_steps - cfg.warmup_steps)),
                       0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * frac))
    scale = cfg.min_lr_ratio + (1.0 - cfg.min_lr_ratio) * cos
    return cfg.lr * warm * scale


def global_norm(tree: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """The f32 L2 norm over every tensor of ``tree``: one sum of squares
    per tensor, then the sum of those.  The JAX package sums per JAX leaf
    (a whole layer stack at once), so the two may round differently, in
    the last bits of f32.

    DTensors (Shard or Replicate placements) reduce across ranks: each
    rank sums the squares of its shards, grouped by the mesh dimensions
    a tensor is split over, and each group's sum is all-reduced over
    those dimensions once (a replicated tensor counts once); the result
    is a plain 0-d tensor, the same on every rank."""
    sums = [torch.sum(torch.square(x.to(torch.float32)))
            for x in tree.values() if not is_dtensor(x)]
    groups: Dict[tuple, list] = {}
    for x in tree.values():
        if is_dtensor(x):
            split = tuple(i for i, p in enumerate(x.placements)
                          if p.is_shard())
            groups.setdefault((x.device_mesh, split), []).append(x)
    for (mesh, split), xs in groups.items():
        from torch.distributed.tensor import DTensor, Partial, Replicate
        local = torch.sum(torch.stack([
            torch.sum(torch.square(x.to_local().to(torch.float32)))
            for x in xs]))
        part = DTensor.from_local(
            local, mesh, [Partial() if i in split else Replicate()
                          for i in range(mesh.ndim)])
        sums.append(part.full_tensor())
    return torch.sqrt(torch.sum(torch.stack(sums)))


def jax_rank(name: str, t: torch.Tensor) -> int:
    """The rank of the JAX package's leaf holding parameter ``name``: the
    tensor's rank plus one stack axis per layer index in the name
    (``layers.{i}.*``: 1; ``periods.{i}.attn.*``: 1;
    ``periods.{i}.moe.{j}.*``: 2), as `repro_torch.convert` unstacks the
    JAX trees."""
    return t.dim() + sum(part.isdigit() for part in name.split("."))


def init_opt(params: Mapping[str, torch.Tensor],
             moments_dtype: torch.dtype = torch.float32,
             with_err: bool = True) -> OptState:
    """Zero moments in ``moments_dtype`` (bf16 halves their memory), and
    a zero f32 error-feedback buffer with ``with_err``, each on its
    parameter's device and, for a DTensor parameter, in its placements
    (the JAX dry run's ``opt_specs``: moments inherit their parameter's
    sharding)."""
    def zeros(dtype):
        return {n: torch.zeros_like(p.detach(), dtype=dtype,
                                    memory_format=torch.contiguous_format)
                for n, p in params.items()}
    first = next(iter(params.values()))
    step = torch.zeros((), dtype=torch.int32,
                       device=(first.to_local() if is_dtensor(first)
                               else first).device)
    return OptState(step=step, mu=zeros(moments_dtype),
                    nu=zeros(moments_dtype),
                    err=zeros(torch.float32) if with_err else None)


@torch.no_grad()
def compress_grads(grads: Mapping[str, torch.Tensor],
                   err: Mapping[str, torch.Tensor], enabled: bool = True
                   ) -> Tuple[Tensors, Tensors]:
    """bf16 compression with error feedback: ``(g', err')`` with ``g' =
    bf16(g + err)`` widened back to f32 and ``err' = (g + err) - g'``."""
    if not enabled:
        return dict(grads), dict(err)
    comp, new_err = {}, {}
    for name, g in grads.items():
        g32 = g.to(torch.float32) + err[name]
        gc = g32.to(torch.bfloat16).to(torch.float32)
        comp[name], new_err[name] = gc, g32 - gc
    return comp, new_err


@torch.no_grad()
def apply_updates(params: Mapping[str, torch.Tensor],
                  grads: Mapping[str, torch.Tensor], state: OptState,
                  cfg: AdamWConfig) -> Tuple[Mapping[str, torch.Tensor],
                                             OptState, dict]:
    """One AdamW step: ``(params, state, {"grad_norm", "lr"})``.

    The parameters and the moments are written in place (the same
    tensors come back, so a model holding them is updated); the step
    count is a new tensor.  On DTensors every op is local to each
    rank's shards, but the norm (`global_norm`); the gradients must be in
    their parameters' placements."""
    with dtensor_context(*params.values()):
        return _apply_updates(params, grads, state, cfg)


def _apply_updates(params, grads, state, cfg):
    gnorm = global_norm(grads)
    scale = torch.clamp(torch.full_like(gnorm, cfg.clip_norm)
                        / (gnorm + 1e-9), max=1.0)
    step = state.step + 1
    lr = cosine_schedule(cfg, state.step)
    b1c = 1.0 - cfg.b1 ** step.to(torch.float32)
    b2c = 1.0 - cfg.b2 ** step.to(torch.float32)
    f32 = torch.float32
    for name, p in params.items():
        m, v = state.mu[name], state.nu[name]
        g = grads[name].to(f32) * scale
        m32 = cfg.b1 * m.to(f32) + (1 - cfg.b1) * g
        v32 = cfg.b2 * v.to(f32) + (1 - cfg.b2) * g * g
        mhat, vhat = m32 / b1c, v32 / b2c
        m.copy_(m32)
        v.copy_(v32)
        delta = mhat / (torch.sqrt(vhat) + cfg.eps)
        if jax_rank(name, p) >= 2:  # decoupled decay on the JAX matrices
            delta = delta + cfg.weight_decay * p.to(f32)
        p.copy_(p.to(f32) - lr * delta)
    return params, OptState(step, state.mu, state.nu, state.err), {
        "grad_norm": gnorm, "lr": lr}
