"""Frozen copies of the pieces of the program that make the benchmark's
inputs: the arithmetic task and its prompts (``data/arithmetic.py``), the
character tokenizer (``data/tokenizer.py``), ``make_problems`` and
``poisson_arrivals`` (``serving/evaluate.py``) and the votes
(``core/voting.py``). The benchmark reads the program's versions of none
of them, so a later change to the program cannot change the traffic or
the yardstick's answers.
"""
from __future__ import annotations

import dataclasses
import random
import re
from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

MOD = 10
OPS = "+-*"

# the tokenizer: specials, then characters (ids fixed by this order)
SPECIALS = ["<pad>", "<bos>", "<eos>", "<think>", "</think>", "\n\n",
            "boxed{", "}"]
CHARS = list("0123456789+-*=() ")
VOCAB = SPECIALS + CHARS
TOK2ID = {t: i for i, t in enumerate(VOCAB)}
PAD_ID, BOS_ID, EOS_ID = TOK2ID["<pad>"], TOK2ID["<bos>"], TOK2ID["<eos>"]
STEP_ID = TOK2ID["\n\n"]
TASK_VOCAB = len(VOCAB)


def encode(text: str, add_bos: bool = False) -> List[int]:
    ids: List[int] = [BOS_ID] if add_bos else []
    i = 0
    while i < len(text):
        for sp in SPECIALS[3:]:
            if text.startswith(sp, i):
                ids.append(TOK2ID[sp])
                i += len(sp)
                break
        else:
            if text[i] in TOK2ID:
                ids.append(TOK2ID[text[i]])
            i += 1
    return ids


def decode(ids: Sequence[int]) -> str:
    return "".join(VOCAB[i] for i in ids if 0 <= i < len(VOCAB)
                   and i not in (PAD_ID, BOS_ID, EOS_ID))


@dataclasses.dataclass
class Problem:
    operands: List[int]
    ops: List[str]

    @property
    def text(self) -> str:
        s = str(self.operands[0])
        for op, x in zip(self.ops, self.operands[1:]):
            s += op + str(x)
        return s + "="

    def steps(self) -> List[Tuple[int, str, int, int]]:
        acc, out = self.operands[0] % MOD, []
        for op, x in zip(self.ops, self.operands[1:]):
            nxt = ((acc + x) if op == "+" else (acc - x) if op == "-"
                   else (acc * x)) % MOD
            out.append((acc, op, x, nxt))
            acc = nxt
        return out


def gen_problem(rng: random.Random, n_steps: Tuple[int, int]) -> Problem:
    k = rng.randint(*n_steps)
    return Problem(operands=[rng.randint(0, 9) for _ in range(k + 1)],
                   ops=[rng.choice(OPS) for _ in range(k)])


def make_problems(n: int, seed: int, n_steps: Tuple[int, int]) -> List[Problem]:
    rng = random.Random(seed)
    return [gen_problem(rng, n_steps) for _ in range(n)]


def worked_example(p: Problem) -> str:
    """The gold trace of ``p`` after its prompt: one step per operation."""
    body = "".join(f"{a}{op}{x}={n}\n\n" for a, op, x, n in p.steps())
    return f"{p.text}<think>{body}</think>boxed{{{p.steps()[-1][3]}}}"


def poisson_arrivals(n: int, rate_per_s: float, seed: int) -> List[float]:
    """Arrival offsets (seconds) of a Poisson process of ``rate_per_s``."""
    rng = np.random.default_rng(seed)
    return list(np.cumsum(rng.exponential(1.0 / rate_per_s, size=n)))


_BOX_RE = re.compile(r"boxed\{(\d)")


def extract_answer(completion: str) -> Optional[str]:
    m = _BOX_RE.search(completion)
    return m.group(1) if m else None


def weighted_vote(answers: Sequence[Optional[str]],
                  weights: Sequence[float]) -> Optional[str]:
    votes: Dict[str, float] = defaultdict(float)
    for a, w in zip(answers, weights):
        if a is not None and a != "":
            votes[a] += w
    return max(votes, key=votes.get) if votes else None


def running_score(step_scores: Sequence[float]) -> float:
    """A trace's score: the mean of its step scores, 0.5 before the first."""
    return sum(step_scores) / len(step_scores) if step_scores else 0.5
