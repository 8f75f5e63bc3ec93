"""Train, prefill and greedy decode steps of the models of every family.

The PyTorch counterpart of ``repro.models.steps`` (``loss_fn``,
``train_step``, ``prefill_step``, ``make_mips_plan``, ``decode_step``).
`train_step` is one backward pass through `loss_fn` by
``torch.autograd``, the optional bf16 gradient compression, and one
AdamW update written into the model's parameters in place
(`repro_torch.optim.adamw`).  `decode_step` is where the paper
lands in the serving stack: with ``cfg.mips_mode='boundedme'`` the
greedy next-token argmax over the vocab table runs as the BoundedME
bandit — one launch of the fused-cascade kernel for the whole batch
(`repro_torch.core.boundedme_torch.decode_tiled`) — in place of the full
``(d x vocab)`` matvec and argmax.

The head's tile-major table and, on the int8 / int4 tiers, its quantized
artifacts are built once per parameter set and plan (`mips_head`): the
JAX package re-lays and quantizes the table inside its jitted step, with
the same results, but per step that would move the whole table again.
The block permutation of a step is an explicit argument (``perm``), as
everywhere in the port.  With ``mesh`` the head is vocab-sharded: the
table split into row shards over the mesh's devices once per parameter
set (`sharded_mips_head`), and each step one launch per shard and the
exact cross-shard merge, as the JAX package's step runs
``sharded_bounded_me_decode`` under a bound mesh.  A model placed over a
``DeviceMesh`` (`repro_torch.distributed.specs.place_params`) decodes as
the JAX package's does under ``logical_mesh``: with a 'model' axis
larger than 1 its vocab table's row shards run the bandit each on its
rank and the candidates merge after one all-gather
(`mesh_mips_head`, `repro_torch.distributed.sharding.sharded_decode_mesh`);
with a 'model' axis of 1 each rank runs the single-device head on its
whole table and its own rows of the batch.  The heads read only the
final hidden state, so every family's caches (attention K/V, SSM state,
hybrid periods, encdec cross K/V) pass through them unchanged.
"""

from __future__ import annotations

import dataclasses
import weakref
from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.boundedme_torch import (BlockedPlan, decode_tiled,
                                              draw_perms, make_plan,
                                              quantize_table, tile_table)
from repro_torch.distributed.sharding import (MeshShards, PartitionSpec,
                                              axis_sizes, dtensor_context,
                                              is_dtensor, make_shard_plan,
                                              mesh_table_shards,
                                              quantize_shards, redistribute,
                                              shard_map_compat,
                                              sharded_decode_mesh,
                                              sharded_decode_tiled, spec_of)
from repro_torch.distributed.specs import serving_table_sharding
from repro_torch.models.model import (LM, Caches, logits_from_hidden,
                                      masked_logits)
from repro_torch.obs.trace import span
from repro_torch.optim.adamw import (AdamWConfig, OptState, apply_updates,
                                     compress_grads)

__all__ = ["loss_fn", "train_step", "prefill_step", "make_mips_plan",
           "MipsHead", "mips_head", "ShardedMipsHead", "sharded_mips_head",
           "MeshMipsHead", "mesh_mips_head", "decode_step"]


def loss_fn(model: LM, cfg: ArchConfig, batch: Dict[str, torch.Tensor]
            ) -> Tuple[torch.Tensor, dict]:
    """Mean next-token NLL over the batch: ``(loss, {"loss", "acc"})``.

    ``batch`` holds ``tokens`` and ``labels`` ``(B, S)`` and, for vlm and
    encdec, ``patch_embeds`` / ``enc_frames``.  The NLL is ``logsumexp``
    of the f32 logits (`logits_from_hidden`) less the label's logit;
    ``acc`` counts the labels that are the first index of their row's
    maximum."""
    h, _ = model(batch["tokens"], patch_embeds=batch.get("patch_embeds"),
                 enc_frames=batch.get("enc_frames"))
    with dtensor_context(h):
        logits = logits_from_hidden(model, cfg, h)
        labels = batch["labels"].long()
        if is_dtensor(logits):
            logz, gold, hit = _sharded_nll(logits, labels)
        else:
            logz = torch.logsumexp(logits, dim=-1)
            gold = torch.gather(logits, -1, labels[..., None])[..., 0]
            hit = torch.argmax(logits, dim=-1) == labels
        loss = torch.mean(logz - gold)
        acc = torch.mean(hit.to(torch.float32))
    return loss, {"loss": loss, "acc": acc}


def _vocab_split(logits):
    """``(mesh dims splitting the vocab, each rank's vocab ids, the
    placements of per-rank parts along a new last dim)`` of DTensor
    logits whose last dim may be split over mesh axes."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    last = logits.dim() - 1
    pl = logits.placements
    vdims = [i for i, p in enumerate(pl) if p.is_shard(last)]
    ids = distribute_tensor(
        torch.arange(logits.shape[-1], device=logits.device),
        logits.device_mesh,
        [Shard(0) if i in vdims else Replicate() for i in range(len(pl))],
        src_data_rank=None)
    parts = [Shard(last) if i in vdims else p for i, p in enumerate(pl)]
    return vdims, ids, parts


def _first_of_parts(mx, arg, vdims):
    """The global first argmax from each rank's ``(max, first argmax)``
    parts: the first rank (in vocab order) holding the global maximum."""
    from torch.distributed.tensor import Replicate
    mesh = mx.device_mesh
    mx, arg = (t.redistribute(mesh, [Replicate() if i in vdims else p
                                     for i, p in enumerate(t.placements)])
               for t in (mx, arg))
    first = torch.argmax((mx == mx.amax(-1, keepdim=True)).to(torch.int32),
                         dim=-1, keepdim=True)
    return torch.gather(arg, -1, first)[..., 0]


def _sharded_argmax(logits):
    """``argmax(logits, -1)`` (the first index of the maximum) of DTensor
    logits whose vocab may be split, the vocab never gathered."""
    vdims, ids, parts = _vocab_split(logits)

    def local(lg, vid):
        mx, arg = torch.max(lg, dim=-1)
        return mx[..., None], (arg + vid[0])[..., None]

    mx, arg = shard_map_compat(
        local, mesh=logits.device_mesh,
        in_specs=(logits.placements, ids.placements),
        out_specs=(parts, parts))(logits, ids)
    return _first_of_parts(mx, arg, vdims)


def _sharded_nll(logits, labels):
    """``(logsumexp, the label's logit, label is the first argmax)`` of
    DTensor logits whose vocab may be split over mesh axes, the vocab
    never gathered: each rank takes the logsumexp, the label's logit (0
    where the label is not its own) and the first maximum of its slice,
    and the per-rank parts combine across the vocab ranks (a logsumexp
    and a sum, and the first rank holding the global maximum, as
    ``argmax`` takes the first index)."""
    from torch.distributed.tensor import Partial, Replicate
    pl = logits.placements
    vdims, ids, parts = _vocab_split(logits)
    lab_pl = [Replicate() if i in vdims else p for i, p in enumerate(pl)]
    sum_pl = [Partial() if i in vdims else p for i, p in enumerate(pl)]

    def local(lg, lab, vid):
        idx = lab - vid[0]
        own = (idx >= 0) & (idx < lg.shape[-1])
        g = torch.gather(lg, -1, torch.clamp(idx, 0, lg.shape[-1] - 1)
                         [..., None])[..., 0]
        mx, arg = torch.max(lg.detach(), dim=-1)
        return (torch.logsumexp(lg, dim=-1, keepdim=True),
                torch.where(own, g, torch.zeros_like(g)),
                mx[..., None], (arg + vid[0])[..., None])

    lse, gold, mx, arg = shard_map_compat(
        local, mesh=logits.device_mesh,
        in_specs=(pl, lab_pl, ids.placements),
        out_specs=(parts, sum_pl, parts, parts))(logits, labels, ids)
    top = _first_of_parts(mx, arg, vdims)
    return torch.logsumexp(lse, dim=-1), gold, top == labels


def train_step(model: LM, opt_state: OptState,
               batch: Dict[str, torch.Tensor], cfg: ArchConfig,
               opt_cfg: AdamWConfig, compress: bool = False
               ) -> Tuple[LM, OptState, dict]:
    """One AdamW step: ``(model, opt_state, {"loss", "acc", "grad_norm",
    "lr"})``, the metrics f32 0-d tensors.

    The gradients of every parameter (zeros for one the batch does not
    reach) are compressed to bf16 with error feedback when ``compress``
    and the state has an error buffer, then applied; the model's
    parameters and the moments are updated in place.  Turns the
    parameters' gradients on."""
    params = dict(model.named_parameters())
    for p in params.values():
        if not p.requires_grad:
            p.requires_grad_(True)
    with dtensor_context(*params.values()):
        loss, metrics = loss_fn(model, cfg, batch)
        grads = torch.autograd.grad(loss, list(params.values()),
                                    allow_unused=True)
    grads = {name: torch.zeros_like(p) if g is None else _as_param(g, p)
             for (name, p), g in zip(params.items(), grads)}
    err = opt_state.err
    if compress and err is not None:
        grads, err = compress_grads(grads, err, enabled=True)
    _, opt_state, opt_metrics = apply_updates(params, grads, opt_state,
                                              opt_cfg)
    metrics = {k: (v.full_tensor() if is_dtensor(v) else v).detach()
               for k, v in metrics.items()}
    metrics.update(opt_metrics)
    return model, opt_state._replace(err=err), metrics


def _as_param(g: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """A DTensor gradient in its parameter's placements: the partial sums
    over the batch's ranks reduced (the data-parallel all-reduce, or a
    reduce-scatter under FSDP), as the JAX step's gradients take their
    parameters' shardings; a 16-bit gradient's in f32 (`redistribute`)."""
    if is_dtensor(g) and tuple(g.placements) != tuple(p.placements):
        return redistribute(g, p.device_mesh, p.placements)
    return g


def prefill_step(model: LM, tokens: torch.Tensor, cache_len: int,
                 patch_embeds: Optional[torch.Tensor] = None,
                 enc_frames: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, Caches]:
    """Process the prompt: ``(last-position hidden (B, d), caches)``;
    vlm takes ``patch_embeds``, encdec ``enc_frames``."""
    h, caches = model(tokens, cache_len=cache_len,
                      patch_embeds=patch_embeds, enc_frames=enc_frames)
    return h[:, -1], caches


def make_mips_plan(cfg: ArchConfig, K: int = 1) -> BlockedPlan:
    """The static BoundedME plan of the vocab head: ``value_range`` 4.0,
    tiles of 8 rows, blocks of ``min(512, d_model)`` columns, the
    config's eps, delta and precision."""
    if cfg.mips_precision == "pq":
        raise ValueError("the decode head's plan has no table to calibrate "
                         "a pq error bound on; pq serves through --loop")
    return make_plan(cfg.padded_vocab, cfg.d_model, K=K, eps=cfg.mips_eps,
                     delta=cfg.mips_delta, value_range=4.0, tile=8,
                     block=min(512, cfg.d_model),
                     precision=cfg.mips_precision)


@dataclasses.dataclass
class MipsHead:
    """The bandit head of one parameter set under one plan: the vocab
    table laid out tile-major (in the table's own type) and its quantized
    artifacts on the int tiers."""

    plan: BlockedPlan
    V4: torch.Tensor
    quantized: Optional[tuple]
    n_valid: int
    key: tuple

    def __call__(self, hid: torch.Tensor, perm) -> Tuple[torch.Tensor,
                                                         torch.Tensor]:
        """``(ids (B, 1) int32, scores (B, 1) float32)`` of hidden states
        ``hid (B, d)`` under the block permutation ``perm``."""
        return decode_tiled(self.V4, hid, perm, plan=self.plan,
                            final_exact=True, n_valid=self.n_valid,
                            quantized=self.quantized)


@torch.no_grad()
def mips_head(model: LM, cfg: ArchConfig) -> MipsHead:
    """The model's bandit head under ``cfg``'s plan, built at the first
    call and kept until the plan or the table (its storage or an
    in-place write) changes."""
    plan = make_mips_plan(cfg)
    table = model.head_table
    key = (plan, table.data_ptr(), table._version)
    head = getattr(model, "_mips_head", None)
    if head is None or head.key != key:
        model._mips_head = None              # free the old copy first
        V4 = tile_table(table, plan, table.device)
        quant = (quantize_table(V4, plan) if plan.precision != "fp32"
                 else None)
        model._mips_head = MipsHead(plan, V4, quant, cfg.vocab, key)
    return model._mips_head


@dataclasses.dataclass
class ShardedMipsHead:
    """The vocab-sharded bandit head of one parameter set over one mesh:
    the shard plan (`make_shard_plan` at the head's settings), each row
    shard of the table laid out tile-major on its device, and the shards'
    quantized artifacts on the int tiers."""

    plan: BlockedPlan
    mesh: object
    shards: list
    quantized: Optional[list]
    k_out: int
    n_valid: int
    key: tuple

    def __call__(self, hid: torch.Tensor, perm) -> Tuple[torch.Tensor,
                                                         torch.Tensor]:
        """``(ids (B, 1) int32, scores (B, 1) float32)`` of hidden states
        ``hid (B, d)`` (cast to the table's type, as in the JAX package)
        under the block permutation ``perm``, on the mesh's first
        device."""
        out = sharded_decode_tiled(
            self.shards, hid.to(self.shards[0].dtype), perm, mesh=self.mesh,
            plan=self.plan, K=1, k_out=self.k_out, n_valid=self.n_valid,
            final_exact=True, quantized=self.quantized)
        return out[0], out[1]


@torch.no_grad()
def sharded_mips_head(model: LM, cfg: ArchConfig,
                      mesh) -> ShardedMipsHead:
    """The model's vocab-sharded head under ``cfg`` over ``mesh`` — the
    JAX package's sharded step settings: K = 1, ``value_range`` 4.0,
    tiles of 8 rows, blocks of ``min(512, d_model)``, the padding rows
    masked — built at the first call and kept until the mesh, the plan's
    settings or the table change."""
    if cfg.mips_precision == "pq":
        raise ValueError("the decode head's plan has no table to calibrate "
                         "a pq error bound on; pq serves through --loop")
    table = model.head_table
    key = (id(mesh), cfg.padded_vocab, cfg.d_model, cfg.mips_eps,
           cfg.mips_delta, cfg.mips_precision, table.data_ptr(),
           table._version)
    head = getattr(model, "_sharded_head", None)
    if head is None or head.key != key:
        model._sharded_head = None            # free the old shards first
        plan, _, _, k_out = make_shard_plan(
            cfg.padded_vocab, cfg.d_model, len(mesh.devices), K=1,
            eps=cfg.mips_eps, delta=cfg.mips_delta, value_range=4.0,
            tile=8, block=min(512, cfg.d_model),
            precision=cfg.mips_precision)
        shards = serving_table_sharding(table, mesh, plan)
        model._sharded_head = ShardedMipsHead(plan, mesh, shards,
                                              quantize_shards(shards, plan),
                                              k_out, cfg.vocab, key)
    return model._sharded_head


def _head_settings(cfg: ArchConfig) -> tuple:
    if cfg.mips_precision == "pq":
        raise ValueError("the decode head's plan has no table to calibrate "
                         "a pq error bound on; pq serves through --loop")
    return (cfg.padded_vocab, cfg.d_model, cfg.mips_eps, cfg.mips_delta,
            cfg.mips_precision, cfg.vocab)


@dataclasses.dataclass
class MeshMipsHead:
    """The bandit head of a model placed over a ``DeviceMesh``: the vocab
    table laid out by each rank (`mesh_table_shards`: its row shard over
    'model', or, with a 'model' axis of 1, the whole table under the
    single-device plan) and its quantized artifacts."""

    shards: MeshShards
    n_valid: int
    sharded: bool
    key: tuple
    table: object                      # a weak reference to the table

    @property
    def plan(self) -> BlockedPlan:
        """The plan each rank's launch runs: the shard plan
        (`make_shard_plan` at the head's eps, delta and tier, delta split
        over the shards), or the single-device plan with a 'model' axis
        of 1."""
        return self.shards.plan

    def __call__(self, hid: torch.Tensor, perm, batch_axes=None
                 ) -> torch.Tensor:
        """``ids (B, 1) int32`` of DTensor hidden states ``hid (B, d)``
        (the batch over ``batch_axes``) under the block permutation
        ``perm``, a DTensor split as the batch."""
        if self.sharded:       # the JAX package casts to the table's type
            return sharded_decode_mesh(
                self.shards, hid.to(self.shards.V4.dtype), perm, K=1,
                n_valid=self.n_valid, batch_axes=batch_axes,
                final_exact=True)[0]
        plan, quant = self.plan, self.shards.quantized
        rows = PartitionSpec(batch_axes, None)

        def local(V4_l, h_l, *q):
            return decode_tiled(V4_l, h_l, perm, plan=plan,
                                final_exact=True, n_valid=self.n_valid,
                                quantized=q or None)[0]
        return shard_map_compat(
            local, mesh=self.shards.mesh,
            in_specs=(PartitionSpec("model", None, None, None), rows,
                      *(PartitionSpec("model", *(None,) * (t.dim() - 1))
                        for t in quant or ())),
            out_specs=rows)(self.shards.V4, hid, *(quant or ()))


@torch.no_grad()
def mesh_mips_head(model: LM, cfg: ArchConfig, mesh) -> MeshMipsHead:
    """The bandit head of a model whose vocab table is a DTensor on
    ``mesh``, at the JAX package's settings: with a 'model' axis larger
    than 1 the shard plan (`make_shard_plan`: K = 1, ``value_range``
    4.0, tiles of 8, blocks of ``min(512, d_model)``, delta over the
    shards), else `make_mips_plan`.  Built at the first call and kept
    until the mesh, the settings or the table (the DTensor's identity or
    an in-place write) change; a table of fake tensors is laid out as
    fake tensors, and nothing reads its values."""
    table = model.head_table
    S = axis_sizes(mesh).get("model", 1)
    key = (id(mesh), S, _head_settings(cfg), id(table), table._version)
    head = getattr(model, "_mesh_head", None)
    if head is None or head.key != key or head.table() is not table:
        model._mesh_head = None                # free the old shards first
        if S > 1:
            plan, _, _, k_out = make_shard_plan(
                cfg.padded_vocab, cfg.d_model, S, K=1, eps=cfg.mips_eps,
                delta=cfg.mips_delta, value_range=4.0, tile=8,
                block=min(512, cfg.d_model), precision=cfg.mips_precision)
        else:
            plan = make_mips_plan(cfg)
            k_out = plan.K
        shards = mesh_table_shards(table, mesh, plan, k_out=k_out)
        model._mesh_head = MeshMipsHead(shards, cfg.vocab, S > 1, key,
                                        weakref.ref(table))
    return model._mesh_head


@torch.no_grad()
def decode_step(model: LM, cfg: ArchConfig, caches: Caches,
                tokens: torch.Tensor, pos: int, perm=None, mesh=None
                ) -> Tuple[torch.Tensor, Caches]:
    """One greedy decode step: ``(next_token (B,) int32, caches)``.

    ``cfg.mips_mode='exact'``: the f32 logits of every vocab row, the
    padding rows at -1e30, and the first index of the maximum.
    ``'boundedme'``: the bandit head under ``perm``, the step's block
    permutation shared by the batch (default: `draw_perms` seeded 0),
    with exact final scores and the padding rows masked in the cascade;
    with ``mesh`` (more than one shard) the vocab-sharded head
    (`sharded_mips_head`), its next tokens back on the model's device.
    On a model placed over a ``DeviceMesh`` (DTensor hidden states) the
    bandit head is `mesh_mips_head` on the hidden states' mesh, the
    batch split as the bound rules' 'batch' axis (``spec_of``), and the
    next tokens a DTensor split the same way.  The step, and the heads'
    tables built from the model's, are outside autograd, whether or not
    the parameters require grad.  Spans (`repro_torch.obs.trace.span`):
    ``decode_step``, with ``decode_step.body`` (the model) and
    ``decode_step.head``.
    """
    with span("decode_step"):
        with span("decode_step.body"):
            h, caches = model(tokens, caches=caches, pos=pos)
            hid = h[:, -1]
        with span("decode_step.head"):
            return _decode_head(model, cfg, hid, perm, mesh), caches


def _decode_head(model: LM, cfg: ArchConfig, hid: torch.Tensor, perm,
                 mesh) -> torch.Tensor:
    """`decode_step`'s next tokens ``(B,) int32`` from the final hidden
    states ``hid (B, d)``."""
    if is_dtensor(hid):
        with dtensor_context(hid):
            if cfg.mips_mode == "boundedme":
                head = mesh_mips_head(model, cfg, hid.device_mesh)
                if perm is None:
                    perm = draw_perms(head.plan.n_blocks)
                ids = head(hid, perm, spec_of("batch")[0])
                return ids[:, 0].to(torch.int32)
            if cfg.mips_mode != "exact":
                raise ValueError(f"unknown mips_mode {cfg.mips_mode!r}")
            logits = masked_logits(cfg, model.head_table, hid)
            return _sharded_argmax(logits).to(torch.int32)
    if cfg.mips_mode == "boundedme" and mesh is not None \
            and len(mesh.devices) > 1:
        head = sharded_mips_head(model, cfg, mesh)
        if perm is None:
            perm = draw_perms(head.plan.n_blocks)
        ids, _ = head(hid, perm)
        next_tok = ids[:, 0].to(hid.device)
    elif cfg.mips_mode == "boundedme":
        head = mips_head(model, cfg)
        if perm is None:
            perm = draw_perms(head.plan.n_blocks)
        ids, _ = head(hid, perm)
        next_tok = ids[:, 0]
    elif cfg.mips_mode == "exact":
        next_tok = torch.argmax(masked_logits(cfg, model.head_table, hid),
                                dim=-1)
    else:
        raise ValueError(f"unknown mips_mode {cfg.mips_mode!r}")
    return next_tok.to(torch.int32)
