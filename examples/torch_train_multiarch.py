"""Train a few hundred steps of ANY assigned architecture (reduced
config) on the synthetic task with the PyTorch port — the end-to-end
training loop (``examples/train_multiarch.py``, ported).

    PYTHONPATH=src python examples/torch_train_multiarch.py \\
        --arch mamba2-2.7b --steps 120 [--device cpu]
"""
import argparse
import time

import torch

from repro_torch.configs.registry import ALL_ARCHS, serving_config
from repro_torch.data.dataset import lm_batches
from repro_torch.device import resolve_device
from repro_torch.launch.steps import make_train_step
from repro_torch.models.init import count_params, init_params


def main(argv=None) -> tuple:
    """Trains ``--steps`` steps; returns (first loss, last loss)."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="qwen3-1.7b", choices=ALL_ARCHS)
    ap.add_argument("--steps", type=int, default=120)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = serving_config(args.arch)  # reduced config, task tokenizer
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    print(f"arch={cfg.name} ({cfg.arch_type}) "
          f"params={count_params(params):,}")

    step_fn, opt = make_train_step(cfg, lr=1e-3)
    opt_state = opt.init(params)
    batches = lm_batches(args.seq, args.batch)

    t0 = time.time()
    first = last = None
    for step in range(args.steps):
        arr = torch.from_numpy(next(batches)).to(dev)
        batch = {"tokens": arr[:, :-1], "labels": arr[:, 1:]}
        params, opt_state, loss = step_fn(params, opt_state, batch)
        if first is None:
            first = float(loss)
        last = float(loss)
        if step % 20 == 0 or step == args.steps - 1:
            print(f"  step {step:4d} loss {float(loss):.4f} "
                  f"({time.time() - t0:.1f}s)")
    assert last < first, "loss did not decrease"
    print(f"loss {first:.3f} -> {last:.3f} over {args.steps} steps")
    return first, last


if __name__ == "__main__":
    main()
