"""Model building blocks: norms, RoPE, GQA and cross attention, MLP, MoE,
Mamba2 SSD.

The PyTorch counterpart of ``repro.models.layers``: plain tensor code,
with parameters as a mapping of name -> tensor under the JAX package's
names (``wq``, ``bq``, ``w_gate``, ``ln1_w``, ``router``, ``A_log``, ...)
and the JAX package's layouts (``wq (d, H * D)``, experts ``(E, d, f)``,
activations ``(B, S, H, D)``), so both packages run on the same weights.
The JAX package has no Pallas kernel here; its einsums become
``torch.einsum`` / ``matmul``.

Types follow the JAX package's: a product of two bf16 operands is bf16
unless the JAX code asks for ``preferred_element_type=float32`` (the
attention scores and the PV product), which here is an f32 product of
the operands widened exactly; a product of bf16 and f32 operands (the
MoE router) is f32 of the bf16 operand widened exactly, as JAX promotes;
norms, softmax and the SSD scan run in f32.

Sharding is expressed through logical-axis annotations
(`repro_torch.distributed.sharding.shard`) at the JAX package's places;
they are the identity without a bound mesh or on plain tensors, so the
same code runs on one device and on DTensors over a training mesh.  Ops
without a DTensor sharding rule run under ``local_map`` on the shard the
JAX package would hold: the MoE's routing, dispatch and combine (its
argsort, searchsorted and scatters) and the SSD scan.  The MoE layer is
the JAX package's expert-parallel form (`_moe_ep`, ``_moe_ep_shardmap``)
under a mesh whose 'model' axis divides the experts, and its per-row
dispatch (``_moe_gspmd``) otherwise, each rank taking its slice of the
FFN width (the JAX annotations of the dispatch buffer and the expert
outputs fold into that ``local_map``; the partial sum is reduced once,
after the combine, where GSPMD reduces the expert outputs).

Decode attention over a cache whose sequence is split ('kvseq', over
'model' or over ('data', 'model')) keeps the cache split, as GSPMD's
partition of the JAX step does (`_sdpa_split_kv`): each rank scores the
replicated query against its own keys, and the softmax's max and sum
and the PV product are all-reduced over the sequence's mesh axes.  Where
the port gathers what the JAX package keeps split (another program, the
same function): the query positions' keys at ``long_500k`` prefill and
train (each rank attends over every key, `_sdpa_sharded`); a dimension
its mesh axes do not divide (`shard` leaves it whole); and, under FSDP,
the expert weights and the vocab table over 'data' inside their
``local_map`` (as ``shard_map`` gathers an input over an axis its spec
does not name).
"""

from __future__ import annotations

import functools
import math
from typing import Dict, Mapping, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed.sharding import PartitionSpec as SpecP
from repro_torch.distributed.sharding import (axis_sizes, current_mesh,
                                              fan_out, is_dtensor,
                                              outside_simulated_ranks,
                                              placements, redistribute,
                                              shard, shard_map_compat,
                                              spec_of)
from repro_torch.kernels.ops import chain_sum
from repro_torch.obs.trace import span

__all__ = ["rms_norm", "layer_norm", "norm", "bias_add", "scale_mul",
           "rope", "attention", "mlp", "moe_layer", "mamba2_layer"]

Params = Mapping[str, torch.Tensor]

#: the masked-score fill of the JAX package (not -inf: a fully masked row
#: stays finite)
_MASKED = -1e30


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6
             ) -> torch.Tensor:
    """f32 RMS norm times the f32 weight, cast back to ``x``'s type."""
    dt = x.dtype
    x = x.to(torch.float32)
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * w).to(dt)


def layer_norm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
               eps: float = 1e-6) -> torch.Tensor:
    """f32 layer norm (biased variance, eps 1e-6 as in the JAX package,
    not torch's 1e-5) with the f32 weight and bias, cast back."""
    dt = x.dtype
    x = x.to(torch.float32)
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean((x - mu) ** 2, dim=-1, keepdim=True)
    return ((x - mu) * torch.rsqrt(var + eps) * w + b).to(dt)


def norm(x: torch.Tensor, p: Params, cfg: ArchConfig, name: str
         ) -> torch.Tensor:
    """The config's norm under parameters ``{name}_w`` (and ``{name}_b``
    for ``ln``).  Its output's gradient, a partial sum of the products
    it feeds, is reduced whole before the norm's backward (`fan_out`):
    the norm's input gradient then meets the residual's whole."""
    h = (layer_norm(x, p[f"{name}_w"], p[f"{name}_b"]) if cfg.norm == "ln"
         else rms_norm(x, p[f"{name}_w"]))
    return fan_out(h, 1)[0]


def _reduced_dims(x: torch.Tensor, b: torch.Tensor) -> Tuple[int, ...]:
    """The dimensions of ``x`` that ``b``'s broadcast spans: those ``b``
    lacks (leading) and those it holds at size 1 where ``x`` does not."""
    lead = x.dim() - b.dim()
    return tuple(d for d in range(x.dim()) if d < lead or (
        b.shape[d - lead] == 1 and x.shape[d] != 1))


def _chain_grad(g: torch.Tensor, reduced: Tuple[int, ...]) -> torch.Tensor:
    """``g`` summed over its dimensions ``reduced`` (in their order), the
    others kept in order, by `chain_sum`; a DTensor's on each rank's
    local block under ``local_map``: a partial sum over the mesh axes
    that split the summed dimensions (reduced in f32 by the train step's
    `_as_param`, as XLA all-reduces its ranks' sums), split as ``g``'s
    kept dimensions are."""
    kept = [d for d in range(g.dim()) if d not in reduced]

    def local(t):
        return chain_sum(t.permute(*reduced, *kept), len(reduced))
    if not is_dtensor(g):
        return local(g)
    from torch.distributed.tensor import Partial, Replicate, Shard
    mesh = g.device_mesh
    if any(p.is_partial() for p in g.placements):
        g = redistribute(g, mesh, [Replicate() if p.is_partial() else p
                                   for p in g.placements])
    out = [Replicate() if not p.is_shard() else
           Partial() if p.dim in reduced else Shard(kept.index(p.dim))
           for p in g.placements]
    return shard_map_compat(local, mesh=mesh, in_specs=(list(g.placements),),
                            out_specs=out)(g)


class _Broadcast(torch.autograd.Function):
    """``x + b`` or ``x * b``, ``b`` broadcast over ``x``, with the
    gradient of a bf16 ``b`` summed as the JAX package's program sums it
    (`bias_add`, `scale_mul`)."""

    @staticmethod
    def forward(ctx, x, b, mul):
        ctx.reduced, ctx.shape, ctx.mul = _reduced_dims(x, b), b.shape, mul
        if not mul:
            return x + b
        ctx.save_for_backward(x, b)
        return x * b

    @staticmethod
    def backward(ctx, g):
        gx = gb = None
        if ctx.mul:
            x, b = ctx.saved_tensors
            if ctx.needs_input_grad[0]:
                gx = g * b
            if ctx.needs_input_grad[1]:
                gb = _chain_grad(g * x, ctx.reduced).reshape(ctx.shape)
        else:
            gx = g
            if ctx.needs_input_grad[1]:
                gb = _chain_grad(g, ctx.reduced).reshape(ctx.shape)
        return gx, gb, None


def _chains(x: torch.Tensor, b: torch.Tensor) -> bool:
    """Whether ``b``'s gradient takes the chain sum: a bf16 ``b`` of
    ``x``'s type, being differentiated.  An f16 ``b`` keeps autograd's
    sum: XLA's CPU f16 order departs from the chain past 32 rows, and no
    model trains in f16."""
    return (b.dtype == x.dtype == torch.bfloat16 and b.requires_grad
            and torch.is_grad_enabled())


def bias_add(x: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``x + b``, ``b`` broadcast over ``x``'s leading dimensions.

    The value is ``x + b``.  A bf16 ``b`` added to a bf16 ``x`` gets the
    gradient the JAX package's program computes: XLA transposes
    the broadcast into a bf16 ``reduce`` (one add and one rounding per
    row), where autograd's sum accumulates in f32 and rounds once.  The
    port sums it with `repro_torch.kernels.ops.chain_sum`, in XLA's CPU
    order; on a DTensor each rank sums its own rows and the ranks' sums
    are reduced in f32 (`_chain_grad`).  Any other ``b`` is added as it
    is."""
    return _Broadcast.apply(x, b, False) if _chains(x, b) else x + b


def scale_mul(x: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """``x * s``, ``s`` of ``x``'s rank broadcast over its size-1
    dimensions; a bf16 ``s``'s gradient, ``g * x`` rounded to bf16 and
    summed over those dimensions, is summed as `bias_add` sums (the
    JAX package's bf16 ``reduce``: mamba2's ``D`` skip, the MoE combine's
    gate weights).  Any other ``s`` is multiplied as it is."""
    return _Broadcast.apply(x, s, True) if _chains(x, s) else x * s


def _freqs(half: int, theta: float, device: torch.device) -> torch.Tensor:
    """``exp(-log(theta) * arange(half) / half)`` in f32, as the JAX
    package writes it (not ``theta ** (-2i / d)``, which rounds
    otherwise); computed on the host so every device gets the same, and
    copied to a device once (a copy from the host waits for the card).
    Under a fake mode (the dry run) it is made anew, never cached."""
    from torch._guards import detect_fake_mode
    if detect_fake_mode() is not None:
        return _host_freqs(half, theta).to(device)
    return _cached_freqs(half, theta, device)


def _host_freqs(half: int, theta: float) -> torch.Tensor:
    ar = torch.arange(half, dtype=torch.float32)
    return torch.exp(-math.log(theta) * ar / torch.tensor(float(half)))


@functools.lru_cache(maxsize=16)
def _cached_freqs(half: int, theta: float, device: torch.device
                  ) -> torch.Tensor:
    """`_freqs` kept per device: a plain tensor even where ranks are
    simulated, so the cache holds no simulated ranks' tensor."""
    with outside_simulated_ranks():
        return _host_freqs(half, theta).to(device)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float
         ) -> torch.Tensor:
    """Half-split rotary embedding.  ``x (..., S, H, D)``, ``positions
    (..., S)`` integer; the rotation runs in f32 and is cast back."""
    half = x.shape[-1] // 2
    ang = positions[..., None].to(torch.float32) * _freqs(half, theta,
                                                          x.device)
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def _qkv(x: torch.Tensor, p: Params, cfg: ArchConfig, prefix: str = ""
         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    B, S, _ = x.shape
    H, KV, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    xq, xk, xv = fan_out(x, 3)
    q = xq @ p[f"{prefix}wq"]
    k = xk @ p[f"{prefix}wk"]
    v = xv @ p[f"{prefix}wv"]
    if cfg.qkv_bias:
        q, k, v = (bias_add(q, p[f"{prefix}bq"]),
                   bias_add(k, p[f"{prefix}bk"]),
                   bias_add(v, p[f"{prefix}bv"]))
    # the heads' placement before the split too: DTensor cannot split a
    # dimension sharded otherwise (FSDP's 'data' may leave k on 'model')
    q = shard(q, "batch", "seq", "heads").reshape(B, S, H, D)
    k, v = (shard(t, "batch", "seq", "kv_heads").reshape(B, S, KV, D)
            for t in (k, v))
    return (shard(q, "batch", "seq", "heads", None),
            shard(k, "batch", "seq", "kv_heads", None),
            shard(v, "batch", "seq", "kv_heads", None))


def _scores(qg: torch.Tensor, k: torch.Tensor, scale: float) -> torch.Tensor:
    """``(B, c, KV, G, D) x (B, s, KV, D) -> (B, c, KV, G, s)`` in f32."""
    return torch.einsum("bckgd,bskd->bckgs", qg.float(), k.float()) * scale


def _pv(w: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Softmax weights cast to ``v``'s type, then an f32 PV product."""
    return torch.einsum("bckgs,bskd->bckgd", w.to(v.dtype).float(),
                        v.float())


def _sdpa_chunked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool, q_offset: int = 0, chunk: int = 512
                  ) -> torch.Tensor:
    """Chunked softmax attention: full rows per q-chunk.

    ``q (B, Sq, H, D)``, ``k``/``v (B, Sk, KV, D)`` with ``H = G * KV``.
    Three branches, as in the JAX package: one chunk (``Sq <= chunk`` or
    a ragged ``Sq``), static causal chunks (causal self-attention with
    no offset: chunk i attends to keys ``[0, (i + 1) * chunk)`` and only
    its diagonal block is masked), and chunks with full rows.  The
    causal mask ``kpos <= qpos + q_offset`` also masks a cache's empty
    tail in decode.
    """
    if is_dtensor(q):
        return _sdpa_sharded(q, k, v, causal, q_offset, chunk)
    B, Sq, H, D = q.shape
    KV = k.shape[2]
    G = H // KV
    scale = 1.0 / math.sqrt(D)
    Sk = k.shape[1]

    def one_chunk(qc: torch.Tensor, start: int) -> torch.Tensor:
        c = qc.shape[1]
        s = _scores(qc.reshape(B, c, KV, G, D), k, scale)
        if causal:
            qpos = start + torch.arange(c, device=q.device)[:, None]
            kpos = torch.arange(Sk, device=q.device)[None, :]
            mask = (kpos <= qpos + q_offset)[None, :, None, None, :]
            s = torch.where(mask, s, torch.full_like(s, _MASKED))
        w = torch.softmax(s, dim=-1)
        return _pv(w, v).reshape(B, c, H, D).to(q.dtype)

    if Sq <= chunk or Sq % chunk:
        return one_chunk(q, 0)
    n_chunks = Sq // chunk
    if causal and isinstance(q_offset, int) and q_offset == 0 and Sq == Sk:
        diag = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                     device=q.device))
        outs = []
        for i in range(n_chunks):
            qg = q[:, i * chunk:(i + 1) * chunk].reshape(B, chunk, KV, G, D)
            ctx = (i + 1) * chunk
            s = _scores(qg, k[:, :ctx], scale)
            s[..., i * chunk:] = torch.where(
                diag[None, :, None, None, :], s[..., i * chunk:],
                torch.full_like(s[..., i * chunk:], _MASKED))
            w = torch.softmax(s, dim=-1)
            outs.append(_pv(w, v[:, :ctx]).reshape(B, chunk, H, D)
                        .to(q.dtype))
        return torch.cat(outs, dim=1)
    qs = q.reshape(B, n_chunks, chunk, H, D)
    return torch.stack([one_chunk(qs[:, i], i * chunk)
                        for i in range(n_chunks)], dim=1
                       ).reshape(B, Sq, H, D)


def _sdpa_sharded(q, k, v, causal: bool, q_offset: int, chunk: int):
    """`_sdpa_chunked` on DTensors, under ``local_map``: each rank attends
    with its own batch rows, query heads and (at ``long_500k``) query
    positions, over every key.  Einsums over (batch, heads) split over
    two mesh axes have no sharding rule that holds under the dry run's
    fake tensors, hence the local form.  Where the query heads are split
    and the kv heads are not (their count rarely divides 'model'), each
    rank takes the kv head of each of its query heads (``h // G``; the
    head itself where there are as many), and attends with one kv head
    per query head; where every query head has its own kv head (``G =
    1``) and the keys and values already split their heads as the
    queries do (the encdec cross attention's K/V) they keep that split.  Keys and values split along their
    sequence are gathered here (the query positions' keys at
    ``long_500k``); decode over a split cache takes `_sdpa_split_kv`."""
    from torch.distributed.tensor import (Replicate, Shard,
                                          distribute_tensor)
    H = q.shape[2]
    G = H // k.shape[2]
    mesh = q.device_mesh
    q_pl = [p if p.is_shard() and p.dim in (0, 1, 2) else Replicate()
            for p in q.placements]
    kv_pl = [p if p.is_shard(0) or (G == 1 and p.is_shard(2)
                                    and kp.is_shard(2)) else Replicate()
             for p, kp in zip(q_pl, k.placements)]

    def ids(n, dim):          # each rank's indices along q's dim ``dim``
        return distribute_tensor(
            torch.arange(n, device=q.device), mesh,
            [Shard(0) if p.is_shard(dim) else Replicate() for p in q_pl],
            src_data_rank=None)

    heads, qpos = ids(H, 2), ids(q.shape[1], 1)

    def local(q_l, k_l, v_l, h_l, s_l):
        if q_l.shape[2] < H and k_l.shape[2] * G == H:
            # this rank's query heads, over the kv heads they read
            k_l, v_l = k_l[:, :, h_l // G], v_l[:, :, h_l // G]
        off = s_l[0] + q_offset if q_l.shape[1] < qpos.shape[0] \
            else q_offset
        return _sdpa_chunked(q_l, k_l, v_l, causal, off, chunk)

    return shard_map_compat(
        local, mesh=mesh,
        in_specs=(q_pl, kv_pl, kv_pl, heads.placements, qpos.placements),
        out_specs=q_pl)(q, k, v, heads, qpos)


def _seq_split(t) -> bool:
    """Whether DTensor ``t`` (B, S, KV, D) has its sequence split."""
    return any(p.is_shard(1) for p in t.placements)


def _sdpa_split_kv(q, k, v, q_offset: int):
    """Causal decode attention, ``q (B, Sq, H, D)`` at positions
    ``q_offset + [0, Sq)`` against a cache ``k``/``v (B, S_max, KV, D)``
    whose sequence is split over one or more mesh axes, the cache never
    gathered (the JAX package's 'kvseq' decode as GSPMD partitions it).

    Under ``local_map`` each rank takes the query whole (its batch rows
    as the cache's; replicated over the sequence's axes, every head) and
    scores it in f32 against its own keys, masked by their global
    positions (``kpos <= qpos + q_offset``, the masked fill -1e30).  The
    softmax then reduces over the sequence's mesh axes as GSPMD reduces
    a split reduction: an all-reduce max of each row's max ``M``, an
    all-reduce sum of ``l = sum exp(s - M)``, the weights ``exp(s - M) /
    l`` cast to ``v``'s type as on one device, and an all-reduce sum of
    each rank's f32 PV product.  A rank whose keys all lie past the
    query (a short prompt in a long cache) holds only masked scores: its
    weights are ``exp(-1e30 - M) = 0``, so it adds nothing, and no row
    divides by zero (the query's own key is live on some rank).  Only
    the gradient-free decode step comes here."""
    from torch.distributed import _functional_collectives as funcol
    from torch.distributed.tensor import (Replicate, Shard,
                                          distribute_tensor)
    mesh = k.device_mesh
    Sk = k.shape[1]
    seq_dims = [i for i, p in enumerate(k.placements) if p.is_shard(1)]
    kv_pl = [p if p.is_shard(0) or p.is_shard(1) else Replicate()
             for p in k.placements]
    q_pl = [p if p.is_shard(0) else Replicate() for p in kv_pl]
    kpos = distribute_tensor(
        torch.arange(Sk, device=k.device), mesh,
        [Shard(0) if i in seq_dims else Replicate()
         for i in range(len(kv_pl))], src_data_rank=None)

    def reduce(t, op):        # of f32 parts (`_scores`, `_pv`)
        for i in seq_dims:
            t = funcol.all_reduce(t, op, (mesh, i))
            if isinstance(t, funcol.AsyncCollectiveTensor):
                t = t.wait()
        return t

    def local(q_l, k_l, v_l, kpos_l):
        B, Sq, H, D = q_l.shape
        KV = k_l.shape[2]
        s = _scores(q_l.reshape(B, Sq, KV, H // KV, D), k_l,
                    1.0 / math.sqrt(D))
        qpos = torch.arange(Sq, device=q_l.device)[:, None]
        mask = (kpos_l[None, :] <= qpos + q_offset)[None, :, None, None, :]
        s = torch.where(mask, s, torch.full_like(s, _MASKED))
        e = torch.exp(s - reduce(s.amax(-1, keepdim=True), "max"))
        w = e / reduce(e.sum(-1, keepdim=True), "sum")
        return reduce(_pv(w, v_l), "sum").reshape(B, Sq, H, D) \
            .to(q_l.dtype)

    return shard_map_compat(
        local, mesh=mesh, in_specs=(q_pl, kv_pl, kv_pl, kpos.placements),
        out_specs=q_pl)(q, k, v, kpos)


def attention(x: torch.Tensor, p: Params, cfg: ArchConfig, *,
              positions: Optional[torch.Tensor], causal: bool = True,
              cache: Optional[Dict[str, torch.Tensor]] = None,
              cache_len: Optional[int] = None, pos: Optional[int] = None,
              kv_override: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
              prefix: str = "", rope_on: bool = True, chunk: int = 512
              ) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """GQA attention for train, prefill and decode.

    * train:   ``cache=None, cache_len=None`` -> ``(y, None)``;
    * prefill: ``cache_len=S_max`` -> ``(y, cache)``, the cache
      ``{"k", "v"} (B, S_max, KV, D)`` allocated here with the prompt's
      keys and values at ``[0, S)``;
    * decode:  ``cache`` and ``pos`` -> ``(y, cache)``, the step's keys
      and values written into the cache in place at ``[pos, pos + S)``
      (the JAX package returns an updated copy);
    * cross-attention: ``kv_override=(k, v)`` ``(B, S_e, H, D)`` from the
      encoder -> ``(y, None)``: queries ``x @ {prefix}wq`` with no bias
      and no RoPE, non-causal over every key.

    Spans (`repro_torch.obs.trace.span`): ``layer.attention``, with
    ``layer.attention.sdpa`` around the softmax attention (device time
    too; counter ``kv_bytes``, `_sdpa`).
    """
    with span("layer.attention"):
        B, S, _ = x.shape
        H, D = cfg.n_heads, cfg.head_dim
        if kv_override is not None:
            q = (x @ p[f"{prefix}wq"]).reshape(B, S, H, D)
            k, v = kv_override
            o = _sdpa(q, k, v, k.shape[1], causal=False, chunk=chunk)
            y = shard(o.reshape(B, S, H * D) @ p[f"{prefix}wo"], "batch",
                      "seq", None)
            return y.to(x.dtype), None
        q, k, v = _qkv(x, p, cfg, prefix)
        if rope_on:
            q = rope(q, positions, cfg.rope_theta)
            k = rope(k, positions, cfg.rope_theta)
        new_cache = None
        if cache is None and cache_len is None:               # train
            o = _sdpa(q, k, v, S, causal=causal, chunk=chunk)
        elif cache_len is not None:                           # prefill
            kf = shard(_pad_seq(k, cache_len - S), "batch", "kvseq",
                       "kv_heads", None)
            vf = shard(_pad_seq(v, cache_len - S), "batch", "kvseq",
                       "kv_heads", None)
            new_cache = {"k": kf, "v": vf}
            o = _sdpa(q, k, v, S, causal=causal, chunk=chunk)
        else:                                                 # decode
            pos = int(pos)
            if is_dtensor(cache["k"]):
                new_cache = {n: shard(_cache_write(cache[n], t, pos),
                                      "batch", "kvseq", "kv_heads", None)
                             for n, t in (("k", k), ("v", v))}
            else:
                cache["k"][:, pos:pos + S] = k
                cache["v"][:, pos:pos + S] = v
                new_cache = cache
            o = _sdpa(q, new_cache["k"], new_cache["v"], pos + S,
                      causal=True, q_offset=pos, chunk=chunk,
                      split_kv=(is_dtensor(new_cache["k"])
                                and _seq_split(new_cache["k"])))
        y = o.reshape(B, S, H * D) @ p[f"{prefix}wo"]
        return shard(y, "batch", "seq", None).to(x.dtype), new_cache


def _sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, attended: int,
          causal: bool, q_offset: int = 0, chunk: int = 512,
          split_kv: bool = False) -> torch.Tensor:
    """`_sdpa_chunked` (with ``split_kv``, `_sdpa_split_kv`: a decode
    cache whose sequence is split) in the span ``layer.attention.sdpa``,
    which counts the key and value bytes the step needs, ``kv_bytes``:
    those of the ``attended`` positions, not what the implementation
    reads."""
    with span("layer.attention.sdpa", device=q.device) as sp:
        if sp:
            sp.count("kv_bytes", 2 * k.shape[0] * attended * k.shape[2]
                     * k.shape[3] * k.element_size())
        if split_kv:
            return _sdpa_split_kv(q, k, v, q_offset)
        return _sdpa_chunked(q, k, v, causal=causal, q_offset=q_offset,
                             chunk=chunk)


def _pad_seq(t: torch.Tensor, n: int) -> torch.Tensor:
    """``t (B, S, KV, D)`` with ``n`` zero positions appended (the JAX
    package's ``jnp.pad``); a DTensor whose sequence is whole is padded
    by each rank under ``local_map``, its placements kept (DTensor's own
    rule for ``pad`` fails to plan a redistribution on some releases)."""
    pad = (0, 0, 0, 0, 0, n)
    if not is_dtensor(t) or _seq_split(t):
        return torch.nn.functional.pad(t, pad)
    pl = list(t.placements)
    return shard_map_compat(lambda t_l: torch.nn.functional.pad(t_l, pad),
                            mesh=t.device_mesh, in_specs=(pl,),
                            out_specs=pl)(t)


def _cache_write(cache: torch.Tensor, new: torch.Tensor, pos: int
                 ) -> torch.Tensor:
    """``cache (B, S_max, KV, D)`` with ``new (B, S, KV, D)`` at ``[pos,
    pos + S)``, as a new DTensor (the JAX ``dynamic_update_slice``), each
    rank writing the rows of its own sequence shard: the cache's sequence
    may be split over 'kvseq', where a slice assignment has no sharding
    rule."""
    from torch.distributed.tensor import (Replicate, Shard,
                                          distribute_tensor)
    S = new.shape[1]
    pl = cache.placements
    seq = distribute_tensor(
        torch.arange(cache.shape[1], device=cache.device), cache.device_mesh,
        [Shard(0) if p.is_shard(1) else Replicate() for p in pl],
        src_data_rank=None)

    def write(c, n, s):
        hit = (s >= pos) & (s < pos + S)
        src = n[:, torch.clamp(s - pos, 0, S - 1)]
        return torch.where(hit[None, :, None, None], src, c)

    return shard_map_compat(
        write, mesh=cache.device_mesh,
        in_specs=(pl, [Replicate() if p.is_shard(1) else p for p in pl],
                  seq.placements),
        out_specs=pl)(cache, new, seq)


def _sigmoid(a: torch.Tensor) -> torch.Tensor:
    """``1 / (1 + exp(-a))``, ``jax.nn.sigmoid`` (``logistic``) as XLA
    expands it on the CPU, each op rounding to ``a``'s type."""
    return 1 / (1 + torch.exp(-a))


class _Silu(torch.autograd.Function):
    """`_silu` whose backward is the JAX package's, op for op: the
    transpose of ``jax.nn.silu``'s JVP, ``d = logistic(a)``, ``c = d * (1
    - d)``, ``b * d + (a * b) * c`` for the cotangent ``b``, each product
    and sum rounding to ``a``'s type, where autograd's derivative of the
    written-out forward rounds elsewhere (in bf16 it moved about a third
    of SwiGLU's gate gradients).  In f32 XLA's CPU build contracts the
    last sum into a fused multiply-add, ``fma(b, d, (a * b) * c)``, which
    ``addcmul`` is; XLA's f32 ``exp`` is its own approximation, so the f32
    form stays an ulp from XLA's where ``d`` is."""

    @staticmethod
    def forward(ctx, g):
        ctx.save_for_backward(g)
        return g * _sigmoid(g)

    @staticmethod
    def backward(ctx, b):
        (a,) = ctx.saved_tensors
        d = _sigmoid(a)
        i = (a * b) * (d * (1 - d))
        if a.dtype == torch.float32:
            return torch.addcmul(i, b, d)
        return b * d + i


def _silu(g: torch.Tensor) -> torch.Tensor:
    """silu written out as XLA expands ``jax.nn.silu`` on the CPU: ``g * 1
    / (1 + exp(-g))``.  In bf16 each of those ops rounds, where a fused
    silu or sigmoid rounds once and differs in about a third of the
    elements.  Its gradient is the JAX package's (`_Silu`)."""
    if torch.is_grad_enabled() and g.requires_grad:
        return _Silu.apply(g)
    return g * _sigmoid(g)


def _gelu_tanh(h: torch.Tensor):
    """``(c, k, tanh(c * (h + k * h^3)))`` of `_gelu`, the constants
    ``sqrt(2 / pi)`` and ``0.044715`` in ``h``'s type."""
    c, k = (torch.tensor(v, dtype=h.dtype, device=h.device)
            for v in (math.sqrt(2 / math.pi), 0.044715))
    return c, k, torch.tanh(c * (h + k * (h * (h * h))))


class _Gelu(torch.autograd.Function):
    """`_gelu` whose backward is the JAX package's, op for op: the
    transpose of ``jax.nn.gelu``'s JVP, each product and sum rounding to
    ``h``'s type in its order (``3 h^2`` from ``integer_pow``, the tanh
    rule ``v + v * tanh``), where autograd's derivative of the written-
    out forward rounds elsewhere (in bf16 it moved most of whisper's
    ``b_up`` gradient)."""

    @staticmethod
    def forward(ctx, h):
        ctx.save_for_backward(h)
        return h * (0.5 * (1.0 + _gelu_tanh(h)[2]))

    @staticmethod
    def backward(ctx, r):
        (a,) = ctx.saved_tensors
        c, k, i = _gelu_tanh(a)
        t = r * (0.5 * (1.0 + i))
        v = (0.5 * (a * r)) * (1.0 - i)
        y = c * (v + v * i)
        return (t + y) + (k * y) * (3.0 * (a * a))


def _gelu(h: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default, the tanh approximation (torch's default
    is the erf form), written out as the JAX package computes it: ``h *
    (0.5 * (1 + tanh(c * (h + 0.044715 * h^3))))`` with the constants in
    ``h``'s type and each op rounding to it, as for `_silu`; its gradient
    as the JAX package's (`_Gelu`)."""
    if torch.is_grad_enabled() and h.requires_grad:
        return _Gelu.apply(h)
    return h * (0.5 * (1.0 + _gelu_tanh(h)[2]))


def mlp(x: torch.Tensor, p: Params, cfg: ArchConfig, prefix: str = ""
        ) -> torch.Tensor:
    """SwiGLU (rms archs): ``(silu(x @ w_gate) * (x @ w_up)) @ w_down``;
    GELU (ln archs, whisper-style): ``gelu(x @ w_up + b_up) @ w_down +
    b_down``.  The output's annotation is the port's (as the cross
    attention's): the JAX compiler reduces the 'ff'-split product before
    the residual add, where DTensor would carry a partial sum into the
    residual stream and then gather the head's table to meet it.  Span
    ``layer.mlp`` (`repro_torch.obs.trace.span`)."""
    with span("layer.mlp"):
        if cfg.norm == "ln":
            h = shard(_gelu(bias_add(x @ p[f"{prefix}w_up"],
                                     p[f"{prefix}b_up"])),
                      "batch", "seq", "ff")
            y = shard(h @ p[f"{prefix}w_down"], "batch", "seq", None)
            return bias_add(y, p[f"{prefix}b_down"]).to(x.dtype)
        g = x @ p[f"{prefix}w_gate"]
        u = x @ p[f"{prefix}w_up"]
        h = shard(_silu(g) * u, "batch", "seq", "ff")
        return shard(h @ p[f"{prefix}w_down"], "batch", "seq",
                     None).to(x.dtype)


def moe_capacity(cfg: ArchConfig, S: int) -> int:
    """Expert slots per row of ``S`` tokens: ``min(max(8, ceil(S * k * cf
    / E)), S * k)``, in the JAX package's float arithmetic."""
    E, k = cfg.n_experts, cfg.experts_per_token
    cap = max(8, int(-(-S * k * cfg.capacity_factor // E)))
    return min(cap, S * k)


class _Renorm(torch.autograd.Function):
    """`_renorm` whose backward is the JAX package's, op for op: the
    transpose of ``g / max(sum(g, -1), 1e-9)``'s JVP, ``b / e - sum(b *
    (1 / (e * e)) * g, -1) * n`` (``e`` the clamped sum, ``n`` the max's
    weight: 1 above the floor, 1/2 on it, 0 below), the last sum a chain
    over the k gates in index order whose products XLA's CPU build
    contracts into fused multiply-adds (``addcmul``); autograd's
    ``-b * g / (e * e)`` rounds elsewhere (3,573 of 8,192 seeded
    gradients apart at k = 2)."""

    @staticmethod
    def forward(ctx, g):
        s = g.sum(-1, keepdim=True)
        ctx.save_for_backward(g, s)
        return g / torch.clamp(s, min=1e-9)

    @staticmethod
    def backward(ctx, b):
        g, s = ctx.saved_tensors
        e = torch.clamp(s, min=1e-9)
        p = b * (1 / (e * e))
        r = p[..., 0] * g[..., 0]
        for j in range(1, g.shape[-1]):
            r = torch.addcmul(r, p[..., j], g[..., j])
        n = torch.where(s > 1e-9, 1.0, torch.where(s == 1e-9, 0.5, 0.0))
        return b / e + (-r[..., None]) * n


def _renorm(gates: torch.Tensor) -> torch.Tensor:
    """The top-k gates over their sum (floored at 1e-9), f32, as the JAX
    package renormalizes them; its gradient as the JAX package's
    (`_Renorm`)."""
    if torch.is_grad_enabled() and gates.requires_grad:
        return _Renorm.apply(gates)
    return gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)


def _moe_rows(x: torch.Tensor, router: torch.Tensor, wg: torch.Tensor,
              wu: torch.Tensor, wd: torch.Tensor, cfg: ArchConfig,
              cap: int, e_lo: Optional[torch.Tensor] = None
              ) -> torch.Tensor:
    """The routed FFN of ``x (R, T, d)``, each of the R rows dispatched on
    its own with ``cap`` slots per expert, over the ``E_loc = wg.shape[0]``
    experts ``[e_lo, e_lo + E_loc)`` (all of them when ``e_lo`` is None);
    assignments to other experts are dropped, as those past ``cap``.

    The router product is f32 (``x`` widened exactly), top-k takes the
    lower expert first on ties (a stable descending sort, as
    ``jax.lax.top_k``), gates are renormalized over the k.  Each row's
    ``T * k`` assignments are sorted stably by (local) expert; an
    assignment's rank within its expert past ``cap`` is dropped (its slot
    is the discarded row ``E_loc * cap``).  The expert FFN (SwiGLU) runs
    over all ``E_loc * cap`` slots.  Each token's output sums its k gated
    contributions in the model's type in ascending expert id, the order
    the JAX package's scatter-add applies them, one add at a time (no
    atomics, so the card's sums are those of the CPU); a dropped one adds
    a zero.
    """
    R, T, d = x.shape
    k = cfg.experts_per_token
    E_loc = wg.shape[0]
    probs = torch.softmax(x.to(torch.float32) @ router, dim=-1)
    gates, eidx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, eidx = gates[..., :k], eidx[..., :k]                # (R, T, k)
    gates = _renorm(gates)

    flat_e = eidx.reshape(R, T * k)
    if e_lo is not None:                      # the shard's own experts
        off = flat_e - e_lo
        flat_e = torch.where((off >= 0) & (off < E_loc), off, E_loc)
    order = torch.argsort(flat_e, dim=-1, stable=True)
    sorted_e = torch.gather(flat_e, 1, order)
    rank = (torch.arange(T * k, device=x.device)
            - torch.searchsorted(sorted_e, sorted_e, side="left"))
    token = order // k
    dest = torch.where((rank < cap) & (sorted_e < E_loc),
                       sorted_e * cap + rank, E_loc * cap)
    rows = torch.arange(R, device=x.device)[:, None]
    buf = x.new_zeros((R, E_loc * cap + 1, d))
    buf[rows, dest] = x[rows, token]
    buf = buf[:, :E_loc * cap].reshape(R, E_loc, cap, d)

    g = torch.einsum("becd,edf->becf", buf, wg)
    u = torch.einsum("becd,edf->becf", buf, wu)
    out = torch.einsum("becf,efd->becd", _silu(g) * u, wd).to(x.dtype)

    # each assignment's slot, in (token, j) order, then each token's k
    # slots in ascending expert id
    slot = torch.empty_like(dest).scatter_(1, order, dest).reshape(R, T, k)
    by_expert = torch.argsort(eidx, dim=-1, stable=True)
    slot = torch.gather(slot, 2, by_expert)
    w = torch.gather(gates, 2, by_expert).to(out.dtype)
    flat = torch.cat([out.reshape(R, E_loc * cap, d),
                      out.new_zeros((R, 1, d))], dim=1)
    vals = scale_mul(flat[rows[:, :, None], slot], w[..., None])  # R,T,k,d
    y = vals[:, :, 0]
    for j in range(1, k):
        y = y + vals[:, :, j]
    return y


def moe_layer(x: torch.Tensor, p: Params, cfg: ArchConfig) -> torch.Tensor:
    """Top-k routed MoE: the expert-parallel form (`_moe_ep`) under a
    bound mesh whose 'model' axis (of more than one rank) divides the
    experts, else the per-batch-row dispatch (``_moe_gspmd``, capacity
    `moe_capacity` of each row's S tokens; `_moe_rows`), under
    ``local_map`` on DTensors."""
    mesh = current_mesh()
    if mesh is not None and is_dtensor(x):
        msize = axis_sizes(mesh).get("model", 1)
        if msize > 1 and cfg.n_experts % msize == 0:
            return _moe_ep(x, p, cfg, mesh)
        return _moe_gspmd_sharded(x, p, cfg, mesh)
    return _moe_rows(x, p["router"], p["w_gate"], p["w_up"], p["w_down"],
                     cfg, moe_capacity(cfg, x.shape[1]))


def _model_partial(mesh, x_pl) -> list:
    """``x``'s placements with 'model' a partial sum: a local result each
    model rank holds a part of."""
    from torch.distributed.tensor import Partial
    return [Partial() if name == "model" else pl
            for name, pl in zip(mesh.mesh_dim_names, x_pl)]


def _moe_gspmd_sharded(x: torch.Tensor, p: Params, cfg: ArchConfig, mesh
                       ) -> torch.Tensor:
    """``_moe_gspmd`` on DTensors: each rank dispatches its batch rows
    (the JAX package's vmapped per-row dispatch is collective-free) and
    runs the expert FFN over its slice of the FFN width (the expert
    weights' ``ff`` on 'model' when the experts do not divide it), a
    partial sum over 'model' reduced by the closing annotation."""
    x_pl = placements(mesh, spec_of("batch", "seq", None))
    f = shard_map_compat(
        lambda x_l, r, wg, wu, wd: _moe_rows(
            x_l, r, wg, wu, wd, cfg, moe_capacity(cfg, x_l.shape[1])),
        mesh=mesh,
        in_specs=(x_pl, placements(mesh, (None, None)),
                  placements(mesh, (None, None, "model")),
                  placements(mesh, (None, None, "model")),
                  placements(mesh, (None, "model", None))),
        out_specs=_model_partial(mesh, x_pl))
    y = f(x, p["router"], p["w_gate"], p["w_up"], p["w_down"])
    return shard(y, "batch", "seq", None)


def _moe_ep(x: torch.Tensor, p: Params, cfg: ArchConfig, mesh
            ) -> torch.Tensor:
    """The JAX package's ``_moe_ep_shardmap``: every model rank routes all
    of its batch shard's ``T = B_l * S_l`` tokens (capacity over those T,
    not per batch row), keeps only the assignments to its ``E / m`` local
    experts, and the partial outputs are merged with one sum all-reduce
    over 'model' per layer, in f32 for a 16-bit model (`redistribute`:
    XLA compiles the JAX ``psum`` of bf16 parts to an f32 all-reduce)."""
    from torch.distributed.tensor import Replicate, distribute_tensor
    E, k = cfg.n_experts, cfg.experts_per_token
    msize = axis_sizes(mesh)["model"]
    E_loc = E // msize
    x_pl = placements(mesh, spec_of("batch", "seq", None))
    rank = distribute_tensor(torch.arange(msize, device=x.device), mesh,
                             placements(mesh, ("model",)),
                             src_data_rank=None)

    def local(x_l, router, wg, wu, wd, m):
        B_l, S_l, d = x_l.shape
        T = B_l * S_l
        cap = min(max(8, int(-(-T * k * cfg.capacity_factor // E))), T * k)
        y = _moe_rows(x_l.reshape(1, T, d), router, wg, wu, wd, cfg, cap,
                      e_lo=m * E_loc)
        return y.reshape(B_l, S_l, d)

    f = shard_map_compat(
        local, mesh=mesh,
        in_specs=(x_pl, placements(mesh, (None, None)),
                  placements(mesh, ("model", None, None)),
                  placements(mesh, ("model", None, None)),
                  placements(mesh, ("model", None, None)), rank.placements),
        out_specs=_model_partial(mesh, x_pl))
    y = f(x, p["router"], p["w_gate"], p["w_up"], p["w_down"], rank)
    return redistribute(y, mesh, [Replicate() if name == "model" else pl
                                  for name, pl in zip(mesh.mesh_dim_names,
                                                      y.placements)])


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``logaddexp(x, 0)`` (``F.softplus`` returns
    ``x`` itself above 20, within an ulp of this)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _ssd_chunk_scan(xh: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                    Bm: torch.Tensor, Cm: torch.Tensor, chunk: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD scan (Dao & Gu 2024), one scalar decay per head.

    ``xh (B, S, H, P)``, ``dt (B, S, H)``, ``A (H,)`` negative, ``Bm`` /
    ``Cm (B, S, Sdim)`` -> ``(y (B, S, H, P)`` in ``xh``'s type, the
    final f32 state ``(B, H, Sdim, P))``.  A ragged tail is zero-padded
    (``dt = 0`` and ``x = 0`` leave the state untouched); within a chunk
    the decay mask is ``-inf`` before ``exp``.
    """
    Bsz, S0, H, P = xh.shape
    Sdim = Bm.shape[-1]
    pad = -S0 % chunk
    if pad:
        xh, dt, Bm, Cm = (torch.nn.functional.pad(
            t, (0, 0) * (t.ndim - 2) + (0, pad)) for t in (xh, dt, Bm, Cm))
    nc = (S0 + pad) // chunk
    la = (dt * A).to(torch.float32)                           # <= 0
    xs = (xh * dt[..., None]).to(torch.float32)

    def chunks(t):
        return t.reshape((Bsz, nc, chunk) + t.shape[2:])

    la_c, xs_c = chunks(la), chunks(xs)
    B_c, C_c = chunks(Bm.to(torch.float32)), chunks(Cm.to(torch.float32))
    tmask = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                  device=xh.device))[None, :, :, None]
    h = torch.zeros((Bsz, H, Sdim, P), dtype=torch.float32, device=xh.device)
    ys = []
    for c in range(nc):
        la_i, xs_i, B_i, C_i = la_c[:, c], xs_c[:, c], B_c[:, c], C_c[:, c]
        cum = torch.cumsum(la_i, dim=1)                       # (B, c, H)
        gsb = torch.einsum("bts,bcs->btc", C_i, B_i)
        decay = cum[:, :, None, :] - cum[:, None, :, :]       # (B, t, s, H)
        decay = torch.where(tmask, decay, torch.full_like(decay, -torch.inf))
        w = gsb[..., None] * torch.exp(decay)
        y_intra = torch.einsum("btsh,bshp->bthp", w, xs_i)
        y_inter = torch.einsum("bts,bhsp,bth->bthp", C_i, h, torch.exp(cum))
        tail = torch.exp(cum[:, -1:, :] - cum)
        dh = torch.einsum("bcs,bchp,bch->bhsp", B_i, xs_i, tail)
        h = h * torch.exp(cum[:, -1, :])[:, :, None, None] + dh
        ys.append(y_intra + y_inter)
    y = torch.cat(ys, dim=1)[:, :S0]
    return y.to(xh.dtype), h


def mamba2_layer(x: torch.Tensor, p: Params, cfg: ArchConfig, *,
                 cache: Optional[Dict[str, torch.Tensor]] = None,
                 mode: str = "train"
                 ) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """Mamba2 SSD mixer.

    * ``mode='train'``: the chunked scan, no state returned;
    * ``'prefill'``: the chunked scan, and its final state ``{"h": (B, H,
      Sdim, P)}`` f32;
    * ``'decode'``: the per-token recurrence from ``cache["h"]`` (zeros
      without one) -> the new state.
    """
    B, S, _ = x.shape
    di, H, P, Sd = cfg.d_inner, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    f32 = torch.float32
    # z and y carry the 'dinner' split too (the port's annotations): left
    # to DTensor, their gradients may come split along the sequence
    xz, xx, xb, xc, xdt = fan_out(x, 5)
    z = shard(xz @ p["wz"], "batch", "seq", "dinner")
    xh = shard(xx @ p["wx"], "batch", "seq", "dinner").reshape(B, S, H, P)
    Bm, Cm = xb @ p["wB"], xc @ p["wC"]
    dt = _softplus((xdt @ p["wdt"]).to(f32) + p["dt_bias"])
    A = -torch.exp(p["A_log"].to(f32))
    new_cache = None
    if mode in ("train", "prefill"):
        scan = _ssd_chunk_scan
        mesh = current_mesh()
        if mesh is not None and is_dtensor(xh):
            # no sharding rule for the scan: each rank scans its batch
            # rows and its heads (the 'dinner' split of the inner dim)
            b, s, h, _ = spec_of("batch", "seq", "dinner", None)
            scan = shard_map_compat(
                _ssd_chunk_scan, mesh=mesh,
                in_specs=(SpecP(b, s, h, None), SpecP(b, s, h), SpecP(h),
                          SpecP(b, s, None), SpecP(b, s, None), None),
                out_specs=(SpecP(b, s, h, None), SpecP(b, h, None, None)))
        y, h_fin = scan(xh, dt, A, Bm, Cm, min(cfg.ssm_chunk, S))
        if mode == "prefill":
            new_cache = {"h": h_fin}
    else:
        h = (cache["h"] if cache is not None and "h" in cache
             else torch.zeros((B, H, Sd, P), dtype=f32, device=x.device))
        ys = []
        for t in range(S):
            x_t, dt_t = xh[:, t].to(f32), dt[:, t]
            B_t, C_t = Bm[:, t].to(f32), Cm[:, t].to(f32)
            decay = torch.exp(dt_t * A)                        # (B, H)
            dx = torch.einsum("bn,bhp,bh->bhnp", B_t, x_t, dt_t)
            h = h * decay[..., None, None] + dx
            ys.append(torch.einsum("bn,bhnp->bhp", C_t, h))
        y = torch.stack(ys, dim=1).to(x.dtype)
        new_cache = {"h": h}
    y = y + scale_mul(xh, p["D"][None, None, :, None].to(x.dtype))
    y = shard(y.reshape(B, S, di), "batch", "seq", "dinner")
    y = rms_norm(y * _silu(z.to(f32)).to(y.dtype), p["norm_w"])
    return shard(y @ p["out_proj"], "batch", "seq", None).to(x.dtype), \
        new_cache
