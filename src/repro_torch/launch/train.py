"""Training launcher of the PyTorch port (``repro/launch/train.py``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b \
        --smoke --steps 50 --batch 8 --seq 128 [--device cpu]

Runs on the CUDA card unless ``--device`` names another device. Every
layer is checkpointed (``make_train_step``); ``--microbatches k``
accumulates the gradients of k row blocks of each batch. ``--save``
writes the params in the JAX package's ``.npz`` layout, which either
package's ``load_pytree`` reads.
"""
from __future__ import annotations

import argparse
import time
from typing import List, Optional

import torch

from repro_torch.configs.registry import get_config, serving_config
from repro_torch.data.dataset import lm_batches
from repro_torch.device import resolve_device
from repro_torch.launch.steps import make_train_step
from repro_torch.models.init import count_params, init_params
from repro_torch.training.checkpoint import save_pytree


def main(argv: Optional[List[str]] = None) -> List[dict]:
    """Parse ``argv`` (default: the command line), train, and return the
    history: one {step, loss, step_s} per step."""
    ap = argparse.ArgumentParser(
        description="Train an arch of the zoo on the synthetic reasoning "
                    "task (PyTorch port).")
    ap.add_argument("--arch", default="qwen3-4b-thinking")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--serving-vocab", action="store_true",
                    help="wire the smoke config to the task tokenizer")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--save", default=None, help="checkpoint path (.npz)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the "
                         "plain PyTorch path on the host)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = serving_config(args.arch) if args.serving_vocab \
        else get_config(args.arch, smoke=args.smoke)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    print(f"[train] arch={cfg.name} params={count_params(params):,} "
          f"device={dev}")

    step_fn, opt = make_train_step(cfg, lr=args.lr,
                                   microbatches=args.microbatches)
    opt_state = opt.init(params)

    batches = lm_batches(args.seq, args.batch)
    history = []
    t0 = time.time()
    for step in range(args.steps):
        t_step = time.perf_counter()
        arr = torch.from_numpy(next(batches)).to(dev)
        batch = {"tokens": arr[:, :-1], "labels": arr[:, 1:]}
        params, opt_state, loss = step_fn(params, opt_state, batch)
        loss = float(loss)   # waits for the step
        history.append({"step": step, "loss": loss,
                        "step_s": time.perf_counter() - t_step})
        if step % 10 == 0 or step == args.steps - 1:
            print(f"  step {step:5d} loss {loss:.4f} "
                  f"({time.time() - t0:.1f}s)")
    if args.save:
        save_pytree(args.save, params)
        print(f"[train] saved to {args.save}")
    return history


if __name__ == "__main__":
    main()
