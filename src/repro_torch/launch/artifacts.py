"""The serving launcher's trained artifacts: the reasoning LM and its
step scorer, built once and cached under ``ART_DIR`` (the port's copy of
``benchmarks/common.py``'s ``build_artifacts`` / ``load_artifacts``,
which the port cannot import: that module imports jax).

``ART_DIR`` is ``build/repro_torch/artifacts/`` at the root of the
checkout (ignored by git); set the attribute to keep them elsewhere. The
files are in the JAX package's ``.npz`` layout, so either package loads
the other's. ``REPRO_TRAIN_STEPS`` (default 4000) sets the LM's training
steps at build time.
"""
from __future__ import annotations

import json
import os
import time
from pathlib import Path
from typing import Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.registry import serving_config
from repro_torch.core.pipeline import build_step_scorer
from repro_torch.core.scorer import init_scorer
from repro_torch.device import resolve_device
from repro_torch.models.init import init_params
from repro_torch.training.checkpoint import load_pytree, save_pytree
from repro_torch.training.trainer import TrainConfig, train_lm

# <checkout>/src/repro_torch/launch/artifacts.py -> <checkout>/build/...
ART_DIR = str(Path(__file__).resolve().parents[3] / "build" / "repro_torch"
              / "artifacts")


def paths() -> dict:
    """The artifact files under the current ``ART_DIR``."""
    return {name: os.path.join(ART_DIR, f"{name}.{ext}")
            for name, ext in (("model", "npz"), ("scorer", "npz"),
                              ("info", "json"))}


def build_artifacts(verbose: bool = True, device=None) -> dict:
    """Train the LM (``REPRO_TRAIN_STEPS`` steps), build the step scorer
    on its samples, and write both with ``info.json`` (the final loss,
    the scorer's build info, and the seconds each part took) on
    ``device`` (CUDA unless the caller names the CPU). Returns the
    info."""
    dev = resolve_device(device)
    cfg = serving_config()
    os.makedirs(ART_DIR, exist_ok=True)
    tcfg = TrainConfig(steps=int(os.environ.get("REPRO_TRAIN_STEPS", "4000")),
                       seq_len=128, batch_size=32, peak_lr=2e-3, warmup=100,
                       log_every=100)
    if verbose:
        print(f"[artifacts] training LM for {tcfg.steps} steps on {dev} ...")
    t0 = time.perf_counter()
    params, history = train_lm(cfg, tcfg, verbose=verbose, device=dev)
    train_s = time.perf_counter() - t0
    save_pytree(paths()["model"], params)

    if verbose:
        print("[artifacts] building step scorer (sample -> verify -> train)")
    t0 = time.perf_counter()
    scorer, info = build_step_scorer(params, cfg, n_problems=96,
                                     n_samples=8, per_class=160,
                                     verbose=verbose)
    scorer_s = time.perf_counter() - t0
    save_pytree(paths()["scorer"], scorer)
    out = {"train_final_loss": history[-1]["loss"],
           "train_steps": tcfg.steps, "train_s": train_s,
           "build_scorer_s": scorer_s, "device": str(dev),
           "scorer_info": {k: v for k, v in info.items() if k != "history"}}
    with open(paths()["info"], "w") as f:
        json.dump(out, f, indent=2)
    if verbose:
        print(f"[artifacts] done: correct-rate="
              f"{info['sampled_correct_rate']:.2f} "
              f"steps={info['num_steps']} "
              f"fallback={info['fallback_rendered']}")
    return out


def load_artifacts(device=None) -> Tuple[dict, dict, ModelConfig]:
    """Returns (params, scorer_params, cfg) on ``device`` (CUDA unless
    the caller names the CPU); builds them there on first use."""
    dev = resolve_device(device)
    cfg = serving_config()
    p = paths()
    if not (os.path.exists(p["model"]) and os.path.exists(p["scorer"])):
        build_artifacts(device=dev)
    g = torch.Generator(device=dev).manual_seed(0)
    params = load_pytree(p["model"], init_params(cfg, g))
    scorer = load_pytree(p["scorer"], init_scorer(g, cfg.d_model))
    return params, scorer, cfg


if __name__ == "__main__":
    build_artifacts()
