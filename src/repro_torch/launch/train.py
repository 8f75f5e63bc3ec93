"""Training launcher with checkpoint / restart (``repro.launch.train``).

On start it restores the latest checkpoint under ``--ckpt-dir``, if
any, and resumes at exactly the right data batch (the stream is
indexable by step); checkpoints are atomic.  Straggler mitigation is
checkpoint-restart at the step granularity plus a per-step wall-clock
deadline alarm (SIGALRM, ``--step-deadline``, on every rank) that
aborts a hung step so the job controller can reschedule.

It trains on one device (the card by default, the CPU with ``--device
cpu``) or on a ``("data", "model")`` mesh of ranks: under ``torchrun``
one rank per card on NCCL (``gloo`` with ``--device cpu``), the mesh
`make_local_mesh(--data-par, --model-par)` clamped to the ranks there
are, as the JAX package clamps its local mesh.  The weights are placed
by `param_pspecs` (DTensors, leaf for leaf the JAX package's specs) and
each step's batch rows by `batch_pspecs`; the moments take their
parameters' placements.  Only rank 0 logs and writes checkpoints.
Without ``torchrun`` there is one rank, so ``--data-par`` and
``--model-par`` clamp to (1, 1).  `train` also takes a mesh handed in by
code (``mesh=``), as ``serve.build_loop`` does: the tests and
``chip_smoke.py`` run the ranks simulated on one device under
``LocalTensorMode``.

  PYTHONPATH=src python -m repro_torch.launch.train --arch tinyllama-1.1b \\
      --smoke --steps 20 --device cpu --ckpt-dir /tmp/ckpt
  PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \\
      --arch tinyllama-1.1b --data-par 2 --model-par 2

`train` is the loop, returning the trained model and the optimizer
state (and each step's metrics and seconds); `main` wraps it.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import signal
import time
from typing import Optional

import torch

from repro_torch.checkpoint.checkpointer import (latest_step,
                                                 restore_checkpoint,
                                                 save_checkpoint)
from repro_torch.configs import get_config
from repro_torch.configs.base import ArchConfig
from repro_torch.core.boundedme_torch import resolve_device
from repro_torch.data.synthetic import LMStream
from repro_torch.distributed.sharding import (logical_mesh,
                                              outside_simulated_ranks)
from repro_torch.distributed.specs import (batch_pspecs, param_pspecs,
                                           place_params, place_tree)
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.models.model import build_model
from repro_torch.models.steps import train_step
from repro_torch.optim.adamw import AdamWConfig, init_opt

__all__ = ["StepDeadline", "parse_args", "train", "main"]


class StepDeadline:
    """SIGALRM-based per-step deadline: a hung step (a dead peer, a
    straggler) raises instead of blocking forever, so the controller can
    restart from the last checkpoint."""

    def __init__(self, seconds: int):
        self.seconds = seconds

    def __enter__(self):
        if self.seconds > 0:
            signal.signal(signal.SIGALRM,
                          lambda *a: (_ for _ in ()).throw(
                              TimeoutError("step deadline exceeded")))
            signal.alarm(self.seconds)
        return self

    def __exit__(self, *exc):
        if self.seconds > 0:
            signal.alarm(0)
        return False


def parse_args(argv: Optional[list] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced same-family config (CPU-friendly)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--compress", action="store_true",
                    help="bf16+error-feedback gradient compression")
    ap.add_argument("--data-par", type=int, default=1)
    ap.add_argument("--model-par", type=int, default=1)
    ap.add_argument("--step-deadline", type=int, default=0,
                    help="seconds; 0 disables the straggler alarm")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    return ap.parse_args(argv)


def _launched() -> bool:
    """Whether this process is a rank that ``torchrun`` started (with more
    than one rank)."""
    return int(os.environ.get("WORLD_SIZE", "1")) > 1


def _join_group(dev: torch.device) -> torch.device:
    """Join ``torchrun``'s process group: NCCL with one card per rank
    (``LOCAL_RANK``), ``gloo`` on the CPU.  Returns this rank's device."""
    dist = torch.distributed
    if dev.type == "cuda":
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo")
    return dev


def train(args: argparse.Namespace, *, cfg: Optional[ArchConfig] = None,
          halt_at: Optional[int] = None, mesh=None) -> dict:
    """Train ``args.arch`` from step 0 or the latest checkpoint up to
    ``args.steps``.

    ``cfg`` (default ``--arch``, ``--smoke`` reduced) may be passed in;
    the model is `build_model` of it from seed 0 on ``--device``.
    ``mesh`` (default: `make_local_mesh` of ``--data-par`` and
    ``--model-par`` under ``torchrun``, else none) is a ``DeviceMesh``
    whose process group is up; with one of more than one rank the
    weights, moments and batches are DTensors on it.  ``halt_at`` stops
    before that step, as a job killed there would: no final checkpoint.
    The schedule warms up over ``min(20, steps // 5)`` steps and decays
    over ``--steps``.  Each step's time is the host clock around it,
    ending in a synchronisation of the card.

    Returns ``{"cfg", "model", "opt", "opt_cfg", "start", "mesh",
    "history": [{"step", "loss", "acc", "grad_norm", "lr"}], "step_s":
    [...]}``.
    """
    dev = resolve_device(args.device)
    if cfg is None:
        cfg = get_config(args.arch)
        if args.smoke:
            cfg = cfg.smoke()
    if mesh is None and _launched():
        dev = _join_group(dev)
        mesh = make_local_mesh(args.data_par, args.model_par, dev)
    if mesh is not None and mesh.size() == 1:
        mesh = None
    dist = torch.distributed
    rank0 = not (dist.is_available() and dist.is_initialized()) \
        or dist.get_rank() == 0
    say = print if rank0 else (lambda *a, **k: None)
    opt_cfg = AdamWConfig(lr=args.lr, warmup_steps=min(20, args.steps // 5),
                          total_steps=args.steps)
    stream = LMStream(cfg.vocab, batch=args.batch, seq=args.seq, seed=0)
    with outside_simulated_ranks():   # one draw, whatever the ranks
        model = build_model(cfg, seed=0, device=dev)
    bound = (logical_mesh(mesh) if mesh is not None
             else contextlib.nullcontext())
    with bound:
        if mesh is not None:
            place_params(model, param_pspecs(
                cfg, dict(model.named_parameters()), mesh), mesh)
            say(f"[train] mesh {dict(zip(mesh.mesh_dim_names, mesh.shape))}"
                f" of {mesh.size()} ranks")
        params = dict(model.named_parameters())
        opt = init_opt(params, with_err=args.compress)
        start = 0
        if args.ckpt_dir and latest_step(args.ckpt_dir) is not None:
            restored, start = restore_checkpoint(
                args.ckpt_dir, {"params": params, "opt": opt})
            with torch.no_grad():
                for name, p in params.items():
                    p.copy_(restored["params"][name])
            opt = restored["opt"]
            del restored
            say(f"[train] resumed from step {start}")

        sync = ((lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda"
                else (lambda: None))
        history, step_s = [], []
        t0 = time.time()
        for step in range(start, args.steps):
            if halt_at is not None and step >= halt_at:
                break
            b = {k: torch.from_numpy(v).to(dev)
                 for k, v in stream.batch_at(step).items()}
            if mesh is not None:
                b = place_tree(b, batch_pspecs(mesh, args.batch, b), mesh)
            t_step = time.perf_counter()
            with StepDeadline(args.step_deadline):
                model, opt, m = train_step(model, opt, b, cfg, opt_cfg,
                                           compress=args.compress)
                sync()
            step_s.append(time.perf_counter() - t_step)
            history.append({"step": step,
                            **{k: float(v) for k, v in m.items()}})
            if step % args.log_every == 0 or step == args.steps - 1:
                h = history[-1]
                say(f"[train] step={step} loss={h['loss']:.4f} "
                    f"acc={h['acc']:.3f} gnorm={h['grad_norm']:.2f} "
                    f"lr={h['lr']:.2e} ({(time.time() - t0):.1f}s)",
                    flush=True)
            if args.ckpt_dir and (step + 1) % args.ckpt_every == 0:
                save_checkpoint(args.ckpt_dir, step + 1,
                                {"params": params, "opt": opt})
        halted = halt_at is not None and halt_at < args.steps
        if args.ckpt_dir and not halted \
                and latest_step(args.ckpt_dir) != args.steps:
            save_checkpoint(args.ckpt_dir, args.steps,
                            {"params": params, "opt": opt})
    if not halted:
        say(f"[train] done: {args.steps} steps in "
            f"{time.time() - t0:.1f}s")
    return {"cfg": cfg, "model": model, "opt": opt, "opt_cfg": opt_cfg,
            "start": start, "mesh": mesh, "history": history,
            "step_s": step_s}


def main(argv: Optional[list] = None) -> None:
    dist = torch.distributed
    joined = not dist.is_initialized()
    try:
        train(parse_args(argv))
    finally:
        if joined and dist.is_initialized():
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
