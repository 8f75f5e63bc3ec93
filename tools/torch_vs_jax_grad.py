#!/usr/bin/env python3
"""One training batch's loss and gradient norm, the JAX package's against
the port's, on the JAX package's weights, on the CPU.

    JAX_PLATFORMS=cpu PYTHONPATH=src python tools/torch_vs_jax_grad.py \\
        mamba2-130m --layers 24 --dtype float32

The arch at its published width (``--layers`` cuts its depth, ``--dtype``
sets its type), `LMStream` batch 0 of ``--batch`` rows of ``--seq``
tokens.  Prints one JSON line: both packages' loss and gradient norm,
and the JAX gradient norm again with every weight scaled by ``1 +
2^-23`` (one f32 ulp), which says how far a rounding-sized change of the
inputs moves the gradient: where that is as large as the two packages'
distance, the distance is the gradient's conditioning, not a fault.
Like the port's tests, this script imports both packages; the port
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
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.data.synthetic import LMStream  # noqa: E402
from repro_torch.models.steps import loss_fn  # noqa: E402


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("arch")
    ap.add_argument("--layers", type=int, default=None)
    ap.add_argument("--dtype", default=None, help="float32 or bfloat16")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seq", type=int, default=128)
    args = ap.parse_args(argv)
    over = {}
    if args.layers is not None:
        over["n_layers"] = args.layers
    if args.dtype is not None:
        over["dtype"] = args.dtype
    jcfg = dataclasses.replace(jax_get_config(args.arch), **over)
    cfg = dataclasses.replace(get_config(args.arch), **over)
    t0 = time.perf_counter()
    params = jax.jit(init_params, static_argnums=0)(jcfg,
                                                    jax.random.PRNGKey(0))
    batch = LMStream(cfg.vocab, batch=args.batch, seq=args.seq,
                     seed=0).batch_at(0)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    grad = jax.jit(jax.value_and_grad(
        lambda p: jax_loss_fn(p, jcfg, jb), has_aux=True))
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
    out = {"arch": cfg.name, "layers": cfg.n_layers, "dtype": cfg.dtype,
           "batch": args.batch, "seq": args.seq,
           "jax_loss": float(jloss), "port_loss": float(loss),
           "jax_grad_norm": float(global_norm(jg)),
           "port_grad_norm": gnorm,
           "jax_grad_norm_weights_one_ulp_up": float(global_norm(ug)),
           "jax_loss_weights_one_ulp_up": float(uloss),
           "seconds": time.perf_counter() - t0}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
