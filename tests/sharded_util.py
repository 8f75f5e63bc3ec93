"""Helpers of the port's sharded training tests: seeded batches, three
f32 steps of the JAX package's single-device ``train_step`` and of the
port's (single device, or DTensors over a mesh simulated under
``LocalTensorMode``), and the rule that holds two trained parameter sets
together.

The rule (``chip_smoke.py``'s ``train_card_vs_cpu``): losses to rtol
1e-5; all but 0.1 % of the parameters to rtol 1e-4 with atol lr / 100
(a hundredth of one update), and every one within 2 lr a step.  An
AdamW update keeps about the sign of a gradient whose size is near
``eps`` or near the two runs' difference (a sharded step sums its
gradients over ranks, in another order), hence the 0.1 %.
"""

import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config as jax_get_config
from repro.models.model import init_params
from repro.models.steps import train_step as jax_train_step
from repro.optim import adamw as JA
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.data.synthetic import LMStream
from repro_torch.distributed.sharding import logical_mesh
from repro_torch.distributed.specs import (batch_pspecs, param_pspecs,
                                           place_params, place_tree)
from repro_torch.launch.mesh import simulated_mesh
from repro_torch.models.steps import train_step
from repro_torch.optim import adamw as TA

LR, STEPS, B, S = 1e-3, 3, 4, 16

MESHES = [(2, 1), (1, 2), (2, 2)]

FAMILIES = {"dense": "tinyllama-1.1b", "moe": "qwen3-moe-30b-a3b",
            "ssm": "mamba2-130m", "hybrid": "jamba-v0.1-52b",
            "encdec": "whisper-medium", "vlm": "internvl2-26b"}


def configs(arch: str):
    """``(jax cfg, port cfg)``: the smoke config at 2 layers (one hybrid
    period; one encoder layer), capacity factor 16 (no expert drops, so
    the expert-parallel MoE of a 'model' axis computes the single-device
    function).  Each op costs a simulated step once per rank in Python,
    so depth is what the suite's time pays for."""
    kw = dict(n_layers=2, capacity_factor=16.0,
              encoder_layers=min(1, jax_get_config(arch).encoder_layers))
    return (dataclasses.replace(jax_get_config(arch).smoke(), **kw),
            dataclasses.replace(get_config(arch).smoke(), **kw))


def batches(cfg, n: int = STEPS):
    """``n`` numpy batches: `LMStream` tokens and labels, and the family's
    extra input drawn from a seed."""
    stream = LMStream(cfg.vocab, batch=B, seq=S, seed=0)
    rng = np.random.default_rng(5)
    out = []
    for i in range(n):
        b = dict(stream.batch_at(i))
        if cfg.family == "vlm":
            b["patch_embeds"] = rng.normal(
                size=(B, cfg.n_patches, cfg.d_model)).astype(np.float32)
        if cfg.family == "encdec":
            b["enc_frames"] = rng.normal(
                size=(B, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
        out.append(b)
    return out


def opt_configs():
    return (JA.AdamWConfig(lr=LR, warmup_steps=1, total_steps=10),
            TA.AdamWConfig(lr=LR, warmup_steps=1, total_steps=10))


def jax_run(arch: str):
    """The JAX package's single-device steps: ``(params as numpy, losses,
    initial params as numpy)``."""
    jcfg, cfg = configs(arch)
    params = init_params(jcfg, jax.random.PRNGKey(0))
    init = jax.tree.map(np.asarray, params)
    opt = JA.init_opt(params)
    fn = jax.jit(lambda p, o, b: jax_train_step(p, o, b, jcfg,
                                                opt_configs()[0]))
    losses = []
    for b in batches(cfg):
        params, opt, m = fn(params, opt, {k: jnp.asarray(v)
                                          for k, v in b.items()})
        losses.append(float(m["loss"]))
    return jax.tree.map(np.asarray, params), np.array(losses), init


def full(t: torch.Tensor) -> torch.Tensor:
    """A parameter as one plain CPU tensor: a DTensor gathered, ranks
    simulated under LocalTensorMode reconciled (they must agree)."""
    if isinstance(t, torch.distributed.tensor.DTensor):
        t = t.full_tensor()
    if hasattr(t, "reconcile"):
        t = t.reconcile()
    return t.detach().cpu()


def port_run(arch: str, init, mesh=None, device="cpu"):
    """The port's steps from the JAX weights ``init``: on one device, or
    with ``mesh`` (entered by the caller) as DTensors placed by
    `param_pspecs` and `batch_pspecs`.  Returns ``({name: tensor},
    losses)``."""
    _, cfg = configs(arch)
    model = params_from_jax(init, cfg, device=device)
    losses = []
    with (logical_mesh(mesh) if mesh is not None
          else contextlib.nullcontext()):
        if mesh is not None:
            place_params(model, param_pspecs(
                cfg, dict(model.named_parameters()), mesh), mesh)
        opt = TA.init_opt(dict(model.named_parameters()))
        for b in batches(cfg):
            t = {k: torch.from_numpy(v).to(device) for k, v in b.items()}
            if mesh is not None:
                t = place_tree(t, batch_pspecs(mesh, B, t), mesh)
            _, opt, m = train_step(model, opt, t, cfg, opt_configs()[1])
            losses.append(float(m["loss"]))
        named = {n: full(p) for n, p in model.named_parameters()}
    return named, np.array(losses)


def hold(got: dict, want: dict, what: str, steps: int = STEPS) -> None:
    """The rule of this module's docstring over two ``{name: tensor}``
    parameter sets."""
    off = n = 0
    worst = 0.0
    for name, w in want.items():
        d = (got[name].float() - w.float()).abs()
        ref = 1e-4 * w.float().abs()
        worst = max(worst, float(d.max()))
        off += int((d > ref + 1e-2 * LR).sum())
        n += d.numel()
    assert worst <= 2 * LR * steps, f"{what}: largest gap {worst:.3g}"
    assert off <= 1e-3 * n, f"{what}: {off} of {n} parameters apart"


def as_named(params_np, cfg) -> dict:
    """The JAX parameters as ``{port name: tensor}``."""
    model = params_from_jax(params_np, cfg, device="cpu")
    return {n: p.detach() for n, p in model.named_parameters()}




_REF = {}


def reference(arch: str):
    """The JAX run and the port's single-device run of ``arch``, once per
    process: ``(JAX params by port name, JAX losses, initial JAX params,
    port params, port losses)``."""
    if arch not in _REF:
        params, losses, init = jax_run(arch)
        mine, my_losses = port_run(arch, init)
        _REF[arch] = (as_named(params, configs(arch)[1]), losses, init,
                      mine, my_losses)
    return _REF[arch]


def check_sharded(arch: str, shape) -> None:
    """Three sharded steps of ``arch`` on a simulated ``shape`` mesh held
    against the JAX package's and the port's single-device steps."""
    jparams, jl, init, mine, ml = reference(arch)
    with simulated_mesh(shape, device="cpu") as mesh:
        got, losses = port_run(arch, init, mesh)
    np.testing.assert_allclose(losses, jl, rtol=1e-5)
    np.testing.assert_allclose(losses, ml, rtol=1e-5)
    np.testing.assert_allclose(ml, jl, rtol=1e-5)
    hold(got, mine, f"{arch} {shape} vs the port's single device")
    hold(got, jparams, f"{arch} {shape} vs the JAX package")
