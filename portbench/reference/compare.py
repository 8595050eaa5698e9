"""The comparison that decides ``correct``.

Once the window has closed and the program's state is freed, a sample of
the problems the window answered, drawn from the seed, is run through the
plain reference (``model.py``), each sampled trace teacher-forced as its
prompt followed by the tokens the program served. The numbers, each held
to a limit of its own (``portbench/limits/<cell>.json``):

  logprob_err   the widest difference between the log of the confidence
                the program recorded with each served token (the
                probability of the token under its untempered logits) and
                the reference's log-probability of it
  score_err     the widest difference between a step score the program
                recorded and the reference scorer on the reference's
                hidden state at that step boundary
  (``_median``: the median of the same differences)
  logprob_err_clear_p90  the 90th percentile of the log-probability
                differences at the served tokens whose position no router
                of the reference decides on a near tie (an MoE's last
                chosen expert ahead of the next by under ``NEAR_TIE``
                router logits at some layer, where bf16 rounding can send
                the program's token to another expert); a dense model's
                every token
  logprob_err_settled_p90  the same percentile once each problem's
                prompt is routed the way nearest to what was served: every
                trace of a problem reads its prompt's keys and values, so
                one near tie there that the program's bf16 resolves the
                other way shifts every token of the problem. Among the
                prompt's ``FLIP_TRIES`` narrowest routing decisions under
                ``NEAR_TIE`` (layer and position), the reference flips,
                one at a time and greedily, each that lowers the median
                gap of the problem's clear tokens (:func:`settle`)
  score_count_misses  traces of the window whose number of step scores is
                not the number of step boundaries they fed back (exact: 0)
  prune_misses  prunes whose victim did not hold the least running score
                among the candidates (exact: 0)
  vote_misses   answered problems whose answer is not the score-weighted
                vote of their finished traces' answers, re-read from the
                served tokens (exact: 0)

The control (``control=True``) puts the reference in fp8 in the
program's place: the control's log-probabilities and its scores, against
the f32 reference.
"""
from __future__ import annotations

import random
from typing import Dict, List, Optional

import torch

from portbench import frozen
from portbench.reference import model as ref

NUMBERS = ("logprob_err", "logprob_err_median", "logprob_err_clear_p90",
           "logprob_err_settled_p90", "score_err", "score_err_median",
           "score_count_misses", "prune_misses", "vote_misses")
NEAR_TIE = 0.02
FLIP_TRIES = 8


def sample(served: List[dict], seed: int, check: dict) -> List[dict]:
    """Probes drawn from the seed: up to ``check["problems"]`` answered
    problems (the one with the longest trace always among them), and from
    each its longest trace and ``check["traces_per_problem"] - 1``
    others."""
    rng = random.Random(seed ^ 0xC0FFEE)
    done = [s for s in served if s["result"].status == "completed"]

    def longest(s):
        return max(t.num_tokens for t in s["result"].traces)

    if not done:
        return []
    first = max(done, key=longest)
    rest = [s for s in done if s is not first]
    chosen = [first] + rng.sample(rest, min(check["problems"] - 1, len(rest)))
    probes = []
    for s in chosen:
        traces = sorted(s["result"].traces, key=lambda t: -t.num_tokens)
        pick = [traces[0]] + rng.sample(
            traces[1:], min(check["traces_per_problem"] - 1, len(traces) - 1))
        for t in pick:
            if t.num_tokens:
                probes.append({"prompt": list(s["problem"].prompt),
                               "out": list(t.output_tokens),
                               "scores": list(t.step_scores),
                               "confs": list(t.token_confidences)})
    return probes


def _boundaries(out: List[int]) -> List[int]:
    """Output indices whose token the program fed back as a step
    boundary: every served token but the last is an input."""
    return [j for j in range(len(out) - 1) if out[j] == frozen.STEP_ID]


def _rows(p: dict) -> slice:
    """The positions of a probe's sequence that predict its served
    tokens."""
    return slice(len(p["prompt"]) - 1, len(p["prompt"]) - 1 + len(p["out"]))


def _ref_logp(cfg: dict, params: dict, p: dict, h: torch.Tensor,
              other: Optional[torch.Tensor] = None) -> dict:
    st = ref.head_stats(cfg, params, h[_rows(p)],
                        torch.tensor(p["out"], device=h.device),
                        None if other is None else other[_rows(p)])
    st["logp"] = (st["target"] - st["lse"]).double()
    return st


def _clear(diff: torch.Tensor, p: dict, margins: torch.Tensor):
    return diff[margins[_rows(p)] >= NEAR_TIE]


def settle(cfg: dict, params: dict, probes: List[dict], got: List,
           clear: List[torch.Tensor], layer_margins: List[torch.Tensor],
           trail: Optional[list] = None) -> List[torch.Tensor]:
    """Each problem's clear gaps with its prompt routed the way nearest to
    what was served: of the prompt's ``FLIP_TRIES`` narrowest routing
    decisions under ``NEAR_TIE`` in the reference (a layer and a
    position), each in turn is resolved the other way on top of those
    kept, and kept where the median of the problem's clear gaps falls.
    ``got``: the served log-probabilities; ``clear``: the gaps with no
    decision flipped. ``trail`` collects each try."""
    groups: Dict[tuple, List[int]] = {}
    for i, p in enumerate(probes):
        groups.setdefault(tuple(p["prompt"]), []).append(i)
    out = []
    for prompt, idx in groups.items():
        lm = layer_margins[idx[0]][:, :len(prompt)]
        near = (lm < NEAR_TIE).nonzero().tolist()
        tries = sorted(near, key=lambda lt: float(lm[lt[0], lt[1]]))
        best = torch.cat([clear[i] for i in idx])
        crit = float(best.median()) if best.numel() else 0.0
        kept: List[tuple] = []
        group = [probes[i] for i in idx]
        for l, t in tries[:FLIP_TRIES]:
            gaps = _flipped_gaps(cfg, params, group, [got[i] for i in idx],
                                 kept + [(l, t)])
            c = float(gaps.median()) if gaps.numel() else crit
            take = c < crit
            if trail is not None:
                trail.append({"prompt": len(prompt), "layer": l, "pos": t,
                              "margin": float(lm[l, t]), "median": c,
                              "kept": take})
            if take:
                kept, best, crit = kept + [(l, t)], gaps, c
        out.append(best)
    return out


def _flipped_gaps(cfg: dict, params: dict, probes: List[dict], got: List,
                  flips: List[tuple]) -> torch.Tensor:
    """The clear gaps of one problem's ``probes`` with the routing
    decisions ``flips`` (layer, prompt position) resolved the other
    way."""
    seqs = [p["prompt"] + p["out"] for p in probes]
    starts = [0]
    for s in seqs[:-1]:
        starts.append(starts[-1] + len(s))
    dev = params["final_norm"].device
    rows: Dict[int, list] = {}
    for l, t in flips:
        rows.setdefault(l, []).extend(s + t for s in starts)
    margins: list = []
    hs = ref.hidden_states(
        cfg, params, seqs, margins=margins,
        flips={l: torch.tensor(r, device=dev) for l, r in rows.items()})
    return torch.cat([_clear((g - _ref_logp(cfg, params, p, h)["logp"])
                             .abs(), p, m)
                      for p, h, m, g in zip(probes, hs, margins, got)])


def series(cfg: dict, params: dict, scorer: dict, probes: List[dict],
           control: bool = False, trail: Optional[list] = None) -> dict:
    """Per served token or boundary of ``probes``: the ``logprob`` (every
    token), ``logprob_clear`` (the tokens clear of routing near ties),
    ``logprob_settled`` (the same, each problem's prompt routed as
    :func:`settle` finds; a dense model's: ``logprob_clear``) and
    ``score`` (every boundary of a trace that holds a score for each)
    differences from the reference; and an MoE's ``margins``, each
    probe's per-position least routing margin in the reference."""
    seqs = [p["prompt"] + p["out"] for p in probes]
    moe = bool(cfg.get("num_experts"))
    margins = [] if moe else None
    layer_margins = [] if moe else None
    h_ref = ref.hidden_states(cfg, params, seqs, margins=margins,
                              layer_margins=layer_margins)
    h_ctl = ref.hidden_states(cfg, params, seqs, fp8=True) if control \
        else [None] * len(seqs)
    out = {"logprob": [], "logprob_clear": [], "score": []}
    got = []
    for i, (p, hr, hc) in enumerate(zip(probes, h_ref, h_ctl)):
        P = len(p["prompt"])
        dev = hr.device
        st = _ref_logp(cfg, params, p, hr, hc)
        got_lp = (st["other_target_logp"] if control else
                  torch.tensor(p["confs"], dtype=torch.float64).log())
        got.append(got_lp.double())
        diff = (got[-1] - st["logp"]).abs()
        out["logprob"].append(diff)
        out["logprob_clear"].append(
            diff if margins is None else _clear(diff, p, margins[i]))
        bounds = _boundaries(p["out"])
        if bounds and (control or len(p["scores"]) == len(bounds)):
            at = torch.tensor([P + j for j in bounds], device=dev)
            want = ref.scores(scorer, hr[at])
            have = (ref.scores(scorer, hc[at], fp8=True) if control
                    else torch.tensor(p["scores"]))
            out["score"].append((have.double() - want.double()).abs())
    out["logprob_settled"] = (settle(cfg, params, probes, got,
                                     out["logprob_clear"], layer_margins,
                                     trail) if moe else out["logprob_clear"])
    res = {k: torch.cat(v) if v else torch.zeros(0, dtype=torch.float64)
           for k, v in out.items()}
    res["margins"] = margins
    return res


def summarize(s: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """The compared numbers of :func:`series`."""
    def q(x, f):
        return float(f(x)) if x.numel() else 0.0

    def p90(x):
        return torch.quantile(x, 0.9)

    return {"logprob_err": q(s["logprob"], torch.max),
            "logprob_err_median": q(s["logprob"], torch.median),
            "logprob_err_clear_p90": q(s["logprob_clear"], p90),
            "logprob_err_settled_p90": q(s["logprob_settled"], p90),
            "score_err": q(s["score"], torch.max),
            "score_err_median": q(s["score"], torch.median)}


def compare(cfg: dict, params: dict, scorer: dict, probes: List[dict],
            control: bool = False) -> Dict[str, float]:
    return summarize(series(cfg, params, scorer, probes, control))


def decisions(served: List[dict], prunes: List[tuple]) -> Dict[str, float]:
    """score_count_misses, prune_misses and vote_misses over every
    problem of the window."""
    prune_misses = sum(1 for victim, least, _ in prunes if victim > least)
    count_misses = sum(len(t.step_scores) != len(_boundaries(t.output_tokens))
                       for s in served for t in s["result"].traces)
    vote_misses = 0
    for s in served:
        res = s["result"]
        if res.status != "completed":
            continue
        done = [t for t in res.traces if t.status.value == "finished"]
        want = frozen.weighted_vote(
            [frozen.extract_answer(frozen.decode(t.output_tokens))
             for t in done],
            [frozen.running_score(t.step_scores) for t in done])
        vote_misses += want != res.answer
    return {"score_count_misses": count_misses, "prune_misses": prune_misses,
            "vote_misses": vote_misses}
