"""The general traffic generator: a mix is a JSON file of parameters
(``portbench/traffic/<name>.json``), and this module turns it and a seed
into the problems of one run.

Every seed gets the same work in another order: the problems' sizes
(their numbers of steps) are one multiset drawn from the mix's
``shape_seed`` and permuted by the run's seed; the open loop's arrival times are one draw of the Poisson process
from ``shape_seed``, its gaps scaled so that the draw keeps the stated
rate, the same in every run; the digits and operators are
the run seed's own. Keys:

  loop            "closed" (one client: the next problem when the last
                  is answered) or "open" (Poisson arrivals at rate_per_s)
  rate_per_s      open loop: problems per second
  problems        closed loop: problems made ready (more than a window
                  answers)
  problem_steps   [lo, hi]: operations per problem, uniform
  traces          traces per problem
  max_new_tokens  tokens per trace
  sampling        temperature, top_k, top_p of every trace
  prefix          null, or {examples, steps, seed}: worked examples of
                  the arithmetic task, the same in every run, before
                  every problem
  prompt_suffix   text after each problem
  engine          the engine's settings for this mix
  shape_seed      seed of the multisets above
"""
from __future__ import annotations

import dataclasses
import math
import random
from typing import List

import numpy as np

from portbench import frozen


@dataclasses.dataclass
class Problem:
    index: int
    prompt: List[int]
    n_traces: int
    arrival_s: float
    max_new_tokens: int
    answer: int


def prefix_text(mix: dict) -> str:
    spec = mix.get("prefix")
    if not spec:
        return ""
    probs = frozen.make_problems(spec["examples"], spec["seed"],
                                 tuple(spec["steps"]))
    return "".join(frozen.worked_example(p) for p in probs)


def problems(mix: dict, seed: int, seconds: float) -> List[Problem]:
    """The run's problems, in submission order."""
    n = (max(1, int(math.floor(mix["rate_per_s"] * seconds)))
         if mix["loop"] == "open" else mix["problems"])
    shape = random.Random(mix["shape_seed"])
    lo, hi = mix["problem_steps"]
    steps = [shape.randint(lo, hi) for _ in range(n)]
    random.Random(seed).shuffle(steps)
    if mix["loop"] == "open":
        gaps = np.random.default_rng(mix["shape_seed"]).exponential(
            1.0 / mix["rate_per_s"], size=n)
        gaps *= n / mix["rate_per_s"] / gaps.sum()   # the rate as stated
        arrivals = [float(a) for a in np.cumsum(gaps) - gaps[0]]
    else:
        arrivals = [0.0] * n
    digits = random.Random(seed ^ 0x5EED)
    head, tail = prefix_text(mix), mix.get("prompt_suffix", "")
    out = []
    for i in range(n):
        p = frozen.gen_problem(digits, (steps[i], steps[i]))
        out.append(Problem(
            index=i, prompt=frozen.encode(head + p.text + tail, add_bos=True),
            n_traces=mix["traces"], arrival_s=arrivals[i],
            max_new_tokens=mix["max_new_tokens"],
            answer=p.steps()[-1][3]))
    return out
