"""The full STEP pipeline, end to end (paper §5.1 "Implementation Details"),
ported from ``repro/core/pipeline.py``:

  1. train a reasoning LM on the synthetic verifiable task
     (``training.trainer.train_lm``);
  2. sample N solutions per training problem from THAT model;
  3. verify each with the deterministic rule-based verifier;
  4. balance correct/incorrect traces, extract last-layer hidden states at
     every "\\n\\n" step boundary, propagate the trace label to all steps;
  5. train the 2-layer-MLP step scorer with class-weighted BCE.

Hidden states are collected teacher-forced (one forward over the sampled
trace), as the engine's fused scorer sees them at decode time. Everything
runs on the device the params live on. Sampling draws from a
``torch.Generator``, so sampled traces differ from the JAX package's for
the same seed; greedy sampling gives the same tokens.
"""
from __future__ import annotations

import dataclasses
import random
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.scorer import ScorerTrainConfig, train_scorer
from repro_torch.data.arithmetic import (Problem, gen_problem, make_prompt,
                                         verify)
from repro_torch.data.tokenizer import get_tokenizer
from repro_torch.models.model import (decode_step, forward_full,
                                      init_decode_cache, write_prefill_kv)
from repro_torch.serving.sampling import SamplingParams, sample_tokens


@dataclasses.dataclass
class SampledTrace:
    problem: Problem
    token_ids: List[int]     # prompt + completion
    prompt_len: int
    text: str                # decoded completion
    answer: Optional[str]
    correct: bool


@torch.no_grad()
def generate_batch(params: dict, cfg: ModelConfig,
                   prompts: Sequence[List[int]], max_new: int,
                   rng: Optional[torch.Generator],
                   sp: Optional[SamplingParams] = None) -> List[List[int]]:
    """Free-running batched sampling over a paged cache with one block row
    per prompt (left-padded prompts, one-shot prefill). Used by the data
    pipeline, where throughput matters more than the paged-pool semantics
    the engine exists to study. ``rng`` lives on the params' device (greedy
    ``sp`` draws nothing)."""
    sp = sp or SamplingParams()
    tok = get_tokenizer()
    dev = params["embed"].device
    B = len(prompts)
    plen = max(len(p) for p in prompts)
    toks = np.full((B, plen), tok.pad_id, np.int32)
    for i, p in enumerate(prompts):
        toks[i, plen - len(p):] = p  # left-pad so last position aligns
    capacity = plen + max_new
    cache = init_decode_cache(cfg, B, capacity, device=dev)
    out = forward_full(params, cfg, torch.from_numpy(toks).to(dev),
                       return_kv=True)
    write_prefill_kv(cfg, cache, out["kvs"],
                     torch.full((B,), plen, dtype=torch.int32, device=dev))
    V = cfg.vocab_size

    def sample(logits):
        logits[:, V:] = -torch.inf
        return sample_tokens(rng, logits, temperature=sp.temperature,
                             top_k=sp.top_k, top_p=sp.top_p)[0]

    cur = sample(out["logits"][:, -1].clone())
    completions = [[t] for t in cur.tolist()]
    positions = torch.full((B,), plen, dtype=torch.int32, device=dev)
    done = np.zeros((B,), bool)
    for _ in range(max_new - 1):
        o = decode_step(params, cfg, cur[:, None], positions, cache,
                        window_len=capacity)
        cur = sample(o["logits"])
        positions += 1
        for i, t in enumerate(cur.tolist()):
            if not done[i]:
                completions[i].append(t)
                if t == tok.eos_id:
                    done[i] = True
        if done.all():
            break
    # trim at eos
    trimmed = []
    for comp in completions:
        if tok.eos_id in comp:
            comp = comp[:comp.index(tok.eos_id) + 1]
        trimmed.append(comp)
    return trimmed


def sample_traces(params: dict, cfg: ModelConfig, problems: List[Problem],
                  n_samples: int, max_new: int = 96, seed: int = 0,
                  batch: int = 32) -> List[SampledTrace]:
    """Sample ``n_samples`` solutions per problem and verify each."""
    tok = get_tokenizer()
    rng = torch.Generator(device=params["embed"].device).manual_seed(seed)
    jobs = [(p, tok.encode(make_prompt(p), add_bos=True))
            for p in problems for _ in range(n_samples)]
    out: List[SampledTrace] = []
    for i in range(0, len(jobs), batch):
        chunk = jobs[i:i + batch]
        comps = generate_batch(params, cfg, [c[1] for c in chunk],
                               max_new, rng)
        for (p, prompt), comp in zip(chunk, comps):
            text = tok.decode(comp)
            ans, ok = verify(p, text)
            out.append(SampledTrace(
                problem=p, token_ids=prompt + comp, prompt_len=len(prompt),
                text=text, answer=ans, correct=ok))
    return out


def balance_traces(traces: List[SampledTrace], per_class: int,
                   seed: int = 0) -> List[SampledTrace]:
    """Paper A.2: randomly select equal numbers of correct/incorrect."""
    rng = random.Random(seed)
    pos = [t for t in traces if t.correct]
    neg = [t for t in traces if not t.correct]
    rng.shuffle(pos)
    rng.shuffle(neg)
    n = min(per_class, len(pos), len(neg))
    sel = pos[:n] + neg[:n]
    rng.shuffle(sel)
    return sel


def _no_steps(cfg: ModelConfig):
    return (np.zeros((0, cfg.d_model), np.float32),
            np.zeros((0,), np.int32), np.zeros((0,), np.int32))


@torch.no_grad()
def collect_boundary_hiddens(params: dict, cfg: ModelConfig,
                             traces: List[SampledTrace], batch: int = 16
                             ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Last-layer hidden state of every "\\n\\n" boundary token, with the
    trace label propagated to every step (paper Label Construction)."""
    tok = get_tokenizer()
    if not traces:
        return _no_steps(cfg)
    dev = params["embed"].device
    S = max(len(t.token_ids) for t in traces)
    hs, ys, tids = [], [], []
    for i in range(0, len(traces), batch):
        chunk = traces[i:i + batch]
        toks = np.full((len(chunk), S), tok.pad_id, np.int32)
        for j, t in enumerate(chunk):
            toks[j, :len(t.token_ids)] = t.token_ids
        out = forward_full(params, cfg, torch.from_numpy(toks).to(dev))
        hidden = out["hidden"].float().cpu().numpy()
        for j, t in enumerate(chunk):
            stop = len(t.token_ids)
            ids = t.token_ids
            if tok.think_close_id in ids:
                stop = ids.index(tok.think_close_id)
            for pos in range(t.prompt_len, stop):
                if ids[pos] == tok.step_id:
                    hs.append(hidden[j, pos])
                    ys.append(int(t.correct))
                    tids.append(i + j)
    if not hs:
        return _no_steps(cfg)
    return np.stack(hs), np.array(ys, np.int32), np.array(tids, np.int32)


def build_step_scorer(params: dict, cfg: ModelConfig,
                      n_problems: int = 48, n_samples: int = 8,
                      per_class: int = 64, seed: int = 0,
                      scfg: Optional[ScorerTrainConfig] = None,
                      n_steps=(5, 9), verbose: bool = False):
    """Run pipeline steps 2-5 on the params' device. Returns
    (scorer_params, info). ``n_steps`` matches the benchmark difficulty
    (the paper trains the scorer on the distribution it serves)."""
    rng = random.Random(seed)
    problems = [gen_problem(rng, n_steps) for _ in range(n_problems)]
    traces = sample_traces(params, cfg, problems, n_samples, seed=seed)
    n_pos = sum(t.correct for t in traces)
    sel = balance_traces(traces, per_class, seed=seed)
    if verbose:
        print(f"  sampled {len(traces)} traces: {n_pos} correct, "
              f"{len(traces) - n_pos} incorrect; training on {len(sel)}")
    h, y, tid = collect_boundary_hiddens(params, cfg, sel)
    if len(h) < 8 or len(set(y.tolist())) < 2:
        # model too weak/strong to give both classes: fall back to rendered
        # corrupted traces (documented deviation, keeps the pipeline total)
        from repro_torch.data.dataset import scorer_dataset
        h, y, tid = scorer_dataset(
            params, cfg, lambda p, t: forward_full(p, cfg, t)["hidden"],
            num_traces=4 * per_class, seed=seed)
        fallback = True
    else:
        fallback = False
    scorer_params, info = train_scorer(h, y, scfg, verbose=verbose,
                                       device=params["embed"].device)
    info.update(num_steps=len(h), pos_rate=float(np.mean(y)),
                sampled_correct_rate=n_pos / max(len(traces), 1),
                fallback_rendered=fallback)
    return scorer_params, info
