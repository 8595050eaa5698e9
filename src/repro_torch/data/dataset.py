"""Data pipeline: LM pretraining batches + scorer hidden-state datasets,
copied from ``repro/data/dataset.py`` (pure Python and numpy, so the
batches are identical for the same seed); only the forward pass the
scorer dataset calls runs in PyTorch."""
from __future__ import annotations

import random
from typing import Iterator, List, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.data.arithmetic import (Problem, gen_problem, make_prompt,
                                         render_trace)
from repro_torch.data.tokenizer import get_tokenizer


def render_example(p: Problem, corrupt_prob: float,
                   rng: random.Random) -> Tuple[List[int], bool]:
    corrupt_from = None
    if rng.random() < corrupt_prob:
        corrupt_from = rng.randint(0, len(p.ops) - 1)
    trace, ok = render_trace(p, corrupt_from, rng)
    tok = get_tokenizer()
    ids = tok.encode(make_prompt(p), add_bos=True) \
        + tok.encode(trace, add_eos=True)
    return ids, ok


def lm_batches(seq_len: int, batch_size: int, seed: int = 0,
               corrupt_prob: float = 0.0,
               n_steps=(3, 9)) -> Iterator[np.ndarray]:
    """Packed LM batches [B, seq_len+1] of concatenated gold traces.
    ``n_steps`` spans the benchmark difficulty range so the served model
    is in-distribution for the evaluation problems."""
    rng = random.Random(seed)
    buf: List[int] = []
    need = batch_size * (seq_len + 1)
    while True:
        while len(buf) < need:
            ids, _ = render_example(gen_problem(rng, n_steps),
                                    corrupt_prob, rng)
            buf.extend(ids)
        arr = np.array(buf[:need], np.int32).reshape(batch_size, seq_len + 1)
        buf = buf[need:]
        yield arr


def scorer_dataset(params, cfg: ModelConfig, forward_fn,
                   num_traces: int = 512, seed: int = 0,
                   batch: int = 32, max_len: int = 160
                   ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Build the step-scorer training set the paper's way (Appendix A.2):
    balanced correct/incorrect traces, hidden states at every "\\n\\n"
    boundary token, trace label propagated to all steps.

    forward_fn(params, tokens [B,S] on the params' device) -> hidden
    [B,S,D]. Returns (hiddens [M,D] fp32, labels [M], trace_ids [M]).
    """
    rng = random.Random(seed)
    tok = get_tokenizer()
    rows, labels, lens = [], [], []
    half = num_traces // 2
    n_pos = n_neg = 0
    while n_pos < half or n_neg < num_traces - half:
        p = gen_problem(rng)
        want_neg = n_neg < num_traces - half and (n_pos >= half
                                                  or rng.random() < 0.5)
        ids, ok = render_example(p, corrupt_prob=1.0 if want_neg else 0.0,
                                 rng=rng)
        if ok and n_pos >= half:
            continue
        if not ok and n_neg >= num_traces - half:
            continue
        n_pos, n_neg = n_pos + ok, n_neg + (not ok)
        ids = ids[:max_len]
        rows.append(ids)
        labels.append(int(ok))
        lens.append(len(ids))

    S = max(lens)
    toks = np.full((len(rows), S), tok.pad_id, np.int32)
    for i, ids in enumerate(rows):
        toks[i, :len(ids)] = ids

    device = params["embed"].device
    hid_rows, y_rows, tid_rows = [], [], []
    for i in range(0, len(rows), batch):
        tb = torch.from_numpy(toks[i:i + batch]).to(device)
        with torch.no_grad():
            hidden = forward_fn(params, tb).float().cpu().numpy()  # [b,S,D]
        for j in range(tb.shape[0]):
            ids = rows[i + j]
            for pos, t in enumerate(ids):
                if t == tok.step_id:
                    hid_rows.append(hidden[j, pos])
                    y_rows.append(labels[i + j])
                    tid_rows.append(i + j)
    return (np.stack(hid_rows), np.array(y_rows, np.int32),
            np.array(tid_rows, np.int32))
