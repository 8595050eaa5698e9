"""Synthetic verifiable reasoning task: chained modular arithmetic.

Stands in for the paper's HMMT training problems: every problem has a
deterministic, rule-based-verifiable answer, traces have step structure
("\n\n"-delimited <think> steps), and corrupted traces give labeled
incorrect examples — mirroring the paper's 5,000-correct/5,000-incorrect
scorer dataset construction (Appendix A.2).

Problem:  "3+5-2+7="  — evaluate left-to-right, every intermediate taken
mod 10. The gold trace writes one step per operation:

  <think>3+5=8\n\n8-2=6\n\n6+7=3\n\n</think>boxed{3}<eos>
"""
from __future__ import annotations

import dataclasses
import random
import re
from typing import List, Optional, Tuple

MOD = 10
OPS = "+-*"


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

    def intermediates(self) -> List[int]:
        acc = self.operands[0] % MOD
        out = []
        for op, x in zip(self.ops, self.operands[1:]):
            if op == "+":
                acc = (acc + x) % MOD
            elif op == "-":
                acc = (acc - x) % MOD
            else:
                acc = (acc * x) % MOD
            out.append(acc)
        return out

    @property
    def answer(self) -> int:
        return self.intermediates()[-1]


def gen_problem(rng: random.Random, n_steps: Tuple[int, int] = (3, 6)
                ) -> Problem:
    k = rng.randint(*n_steps)
    return Problem(operands=[rng.randint(0, 9) for _ in range(k + 1)],
                   ops=[rng.choice(OPS) for _ in range(k)])


def render_trace(p: Problem, corrupt_from: Optional[int] = None,
                 rng: Optional[random.Random] = None) -> Tuple[str, bool]:
    """Gold reasoning trace; if ``corrupt_from`` is a step index, inject an
    arithmetic error there and propagate it (an incorrect trace whose
    prefix is still valid — exactly the early-signal structure the scorer
    must learn). Returns (trace_text, is_correct)."""
    inter = p.intermediates()
    acc = p.operands[0] % MOD
    steps = []
    corrupted = False
    for i, (op, x) in enumerate(zip(p.ops, p.operands[1:])):
        if op == "+":
            nxt = (acc + x) % MOD
        elif op == "-":
            nxt = (acc - x) % MOD
        else:
            nxt = (acc * x) % MOD
        if corrupt_from is not None and i >= corrupt_from and not corrupted:
            assert rng is not None
            nxt = (nxt + rng.randint(1, MOD - 1)) % MOD
            corrupted = True
        steps.append(f"{acc}{op}{x}={nxt}")
        acc = nxt
    body = "\n\n".join(steps) + "\n\n"
    text = f"<think>{body}</think>boxed{{{acc}}}"
    return text, acc == inter[-1]


def make_prompt(p: Problem) -> str:
    return p.text


_BOX_RE = re.compile(r"boxed\{(\d)")


def verify(p: Problem, completion: str) -> Tuple[Optional[str], bool]:
    """Deterministic rule-based verifier (the paper adapts Qwen2.5-Math's).
    Returns (extracted_answer, is_correct)."""
    m = _BOX_RE.search(completion)
    if not m:
        return None, False
    ans = m.group(1)
    return ans, int(ans) == p.answer


def extract_answer(completion: str) -> Optional[str]:
    m = _BOX_RE.search(completion)
    return m.group(1) if m else None
