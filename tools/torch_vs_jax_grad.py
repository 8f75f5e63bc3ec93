#!/usr/bin/env python3
"""One training batch's loss and gradient norm, the JAX package's against
the port's, on the JAX package's weights, on the CPU.

    JAX_PLATFORMS=cpu PYTHONPATH=src python tools/torch_vs_jax_grad.py \\
        mamba2-130m --layers 24 --dtype float32
    JAX_PLATFORMS=cpu PYTHONPATH=src python tools/torch_vs_jax_grad.py \\
        tinyllama-1.1b --smoke --layers 1 --dtype bfloat16 --seq 64 --per-op

The arch at its published width (``--layers`` cuts its depth, ``--dtype``
sets its type), `LMStream` batch 0 of ``--batch`` rows of ``--seq``
tokens.  Prints one JSON line: both packages' loss and gradient norm,
and the JAX gradient norm again with every weight scaled by ``1 +
2^-23`` (one f32 ulp), which says how far a rounding-sized change of the
inputs moves the gradient: where that is as large as the two packages'
distance, the distance is the gradient's conditioning, not a fault.

``--smoke`` takes the arch's smoke widths (``--encoder-layers`` cuts an
encoder's depth).  ``--per-op`` compiles the JAX gradient with each op
rounding to its type (``xla_allow_excess_precision`` off: the program as
its source writes it, the reference of ``tests/jax_per_op.py``) and adds
each parameter's elements apart from it and its largest gap over the
leaf's largest element (``"params"``).  A vlm batch gets seeded
``patch_embeds`` and an encdec batch seeded ``enc_frames``.  Like the
port's tests, this script imports both packages; the port
itself imports no JAX.
"""

import argparse
import dataclasses
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models.model import init_params  # noqa: E402
from repro.models.steps import loss_fn as jax_loss_fn  # noqa: E402
from repro.optim.adamw import global_norm  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import params_from_jax, to_jax_tree  # noqa: E402
from repro_torch.data.synthetic import LMStream  # noqa: E402
from repro_torch.models.steps import loss_fn  # noqa: E402


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("arch")
    ap.add_argument("--layers", type=int, default=None)
    ap.add_argument("--dtype", default=None, help="float32 or bfloat16")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--encoder-layers", type=int, default=None)
    ap.add_argument("--per-op", action="store_true")
    args = ap.parse_args(argv)
    over = {}
    if args.layers is not None:
        over["n_layers"] = args.layers
    if args.encoder_layers is not None:
        over["encoder_layers"] = args.encoder_layers
    if args.dtype is not None:
        over["dtype"] = args.dtype
    jcfg, cfg = (dataclasses.replace(c.smoke() if args.smoke else c, **over)
                 for c in (jax_get_config(args.arch), get_config(args.arch)))
    t0 = time.perf_counter()
    params = jax.jit(init_params, static_argnums=0)(jcfg,
                                                    jax.random.PRNGKey(0))
    batch = LMStream(cfg.vocab, batch=args.batch, seq=args.seq,
                     seed=0).batch_at(0)
    rng = np.random.default_rng(0)
    if cfg.family == "vlm":
        batch["patch_embeds"] = rng.normal(size=(
            args.batch, cfg.n_patches, cfg.d_model)).astype(np.float32)
    if cfg.family == "encdec":
        batch["enc_frames"] = rng.normal(size=(
            args.batch, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    def value_and_grad(p):
        return jax.value_and_grad(lambda q: jax_loss_fn(q, jcfg, jb),
                                  has_aux=True)(p)
    if args.per_op:
        grad = jax.jit(value_and_grad).lower(params).compile(
            compiler_options={"xla_allow_excess_precision": False})
    else:
        grad = jax.jit(value_and_grad)
    (jloss, _), jg = grad(params)
    ulp = jax.tree.map(
        lambda x: x * jnp.asarray(1 + 2.0 ** -23, x.dtype)
        if jnp.issubdtype(x.dtype, jnp.floating) else x, params)
    (uloss, _), ug = grad(ulp)

    model = params_from_jax(jax.tree.map(np.asarray, params), cfg,
                            device="cpu")
    for p in model.parameters():
        p.requires_grad_(True)
    loss, _ = loss_fn(model, cfg, {k: torch.from_numpy(v)
                                   for k, v in batch.items()})
    loss.backward()
    gnorm = float(torch.sqrt(sum((p.grad.double() ** 2).sum()
                                 for p in model.parameters())))
    per_param = {}
    if args.per_op:
        got = to_jax_tree({n: p.grad for n, p in model.named_parameters()},
                          params)
        for path, leaf in jax.tree_util.tree_flatten_with_path(jg)[0]:
            node = got
            for k in path:
                node = node[k.key]
            want = np.asarray(leaf.astype(jnp.float32))
            gap = np.abs(node - want)
            per_param["/".join(k.key for k in path)] = {
                "apart": int((gap > 0).sum()), "size": int(want.size),
                "largest_gap": float(gap.max() / max(np.abs(want).max(),
                                                     1e-30))}
    out = {"arch": cfg.name, "layers": cfg.n_layers, "dtype": cfg.dtype,
           "batch": args.batch, "seq": args.seq,
           "jax_loss": float(jloss), "port_loss": float(loss),
           "jax_grad_norm": float(global_norm(jg)),
           "port_grad_norm": gnorm,
           "jax_grad_norm_weights_one_ulp_up": float(global_norm(ug)),
           "jax_loss_weights_one_ulp_up": float(uloss),
           "per_op": args.per_op, "seconds": time.perf_counter() - t0}
    if per_param:
        out["params"] = per_param
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
