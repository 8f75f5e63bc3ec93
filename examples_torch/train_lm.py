"""End-to-end training example in PyTorch: a ~100M-param LM for a few hundred
steps, on a CUDA card.

The port of ``examples/train_lm.py``: a thin wrapper over the port's
production launcher (`repro_torch.launch.train`) with the same flags and
command, plus ``--device`` (the card by default; ``--device cpu`` trains
on the CPU, and without a card the default fails rather than fall back).
The default arch is mamba2-130m, the cheapest registered one; without
``--full`` it trains the reduced-width (smoke) variant, with ``--full``
the published size (24 layers, d_model 768, vocab 50,280).

    PYTHONPATH=src python examples_torch/train_lm.py --steps 200 --full
    PYTHONPATH=src python examples_torch/train_lm.py --steps 20 --device cpu
"""

import argparse
import os
import subprocess
import sys
import tempfile


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mamba2-130m")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--full", action="store_true",
                    help="published size (needs a card)")
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap.parse_args(argv)


def command(args: argparse.Namespace) -> list:
    """The trainer's command line for ``args``: the JAX example's flags
    (checkpoint every 100 steps, batch 8, sequence 128, lr 3e-3), then
    ``--device``, then ``--smoke`` unless ``--full``."""
    cmd = [sys.executable, "-m", "repro_torch.launch.train",
           "--arch", args.arch, "--steps", str(args.steps),
           "--ckpt-dir", args.ckpt_dir, "--ckpt-every", "100",
           "--batch", "8", "--seq", "128", "--lr", "3e-3",
           "--device", args.device]
    if not args.full:
        cmd.append("--smoke")
    return cmd


def main(argv=None):
    cmd = command(parse_args(argv))
    print("+", " ".join(cmd), flush=True)
    raise SystemExit(subprocess.call(cmd))


if __name__ == "__main__":
    main()
