"""The comparison fails what it must: the control (the reference in fp8
in the program's place) and the run's path broken underneath, each at a
tiny size on the CPU, against the cells' own limits."""
import json

import pytest
import torch

from portbench import drive, manifest as M, run, weights
from portbench.reference import compare as C
from portbench.tests._tiny import TINY_CONFIG, TINY_MIX, run_tiny

MAN = M.Manifest()
CLOSED = ["qwen3-4b.step-n64", "mixtral-8x7b.step-n64"]


def limits(cell):
    return json.loads((MAN.dir / "limits" / f"{cell}.json").read_text())


def failed(numbers, lim):
    return [k for k in C.NUMBERS if k in lim and numbers[k] > lim[k]]


@pytest.mark.parametrize("cell", CLOSED)
@pytest.mark.parametrize("seed", [5, 2 ** 31 + 1, 3 * 10 ** 9])
def test_control_fails_where_the_program_passes(cell, seed):
    spec = MAN.cell(cell)
    cfg = dict(MAN.config(spec["config"]), **TINY_CONFIG)
    mix = dict(MAN.traffic(spec["traffic"]), **TINY_MIX)
    params, scorer = weights.make(cfg, seed, "cpu")
    out, rec = drive.serve_once(run.runtime(), cfg, mix, params, scorer,
                                seed, "cpu", 1.0)
    probes = C.sample(out["served"], seed, mix["check"])
    program = C.compare(cfg, params, scorer, probes)
    program.update(C.decisions(out["served"], rec.prunes))
    control = C.compare(cfg, params, scorer, probes, control=True)
    control.update(score_count_misses=0, prune_misses=0, vote_misses=0)
    assert failed(program, limits(cell)) == []
    assert failed(control, limits(cell)) != []


def _altered(fn):
    def sample(*args, **kw):
        tokens, conf = fn(*args, **kw)
        return (tokens + 1) % 25, conf
    return sample


@pytest.mark.parametrize("cell", CLOSED)
def test_a_token_altered_where_it_is_produced(cell, monkeypatch):
    from repro_torch.serving import engine
    monkeypatch.setattr(engine, "sample_logits",
                        _altered(engine.sample_logits))
    monkeypatch.setattr(engine, "sample_logits_lanes",
                        _altered(engine.sample_logits_lanes))
    assert run_tiny(cell)["correct"] is False


@pytest.mark.parametrize("cell", CLOSED)
def test_a_decode_step_that_leaves_the_pool_unchanged(cell, monkeypatch):
    from repro_torch.models import layers
    monkeypatch.setattr(layers, "paged_kv_update_quant",
                        lambda *args, **kw: None)
    assert run_tiny(cell)["correct"] is False


@pytest.mark.parametrize("cell", CLOSED + ["qwen3-4b.fewshot-open"])
def test_step_scores_left_unwritten(cell, monkeypatch):
    from repro_torch.core import trace
    monkeypatch.setattr(trace.Trace, "add_step_scores",
                        lambda self, scores: None)
    res = run_tiny(cell)
    assert res["correct"] is False
    assert res["compared"]["score_count_misses"]["value"] > 0


@pytest.mark.parametrize("cell", CLOSED + ["qwen3-4b.fewshot-open"])
def test_an_answer_altered_where_it_is_produced(cell, monkeypatch):
    from repro_torch.core import pruning
    monkeypatch.setattr(pruning.StepPolicy, "vote",
                        lambda self, traces: "not an answer")
    res = run_tiny(cell)
    assert res["correct"] is False
    assert res["compared"]["vote_misses"]["value"] > 0


def test_sound_tiny_runs_read_below_the_limits():
    for cell in CLOSED:
        res = run_tiny(cell, seed=17)
        assert res["correct"] is True, res["compared"]
    assert torch.get_default_dtype() == torch.float32


@pytest.mark.parametrize("seed", [11, 2 ** 33 + 5])
def test_a_prompt_tie_resolved_the_other_way_is_settled(seed, monkeypatch):
    """Served log-probabilities from the reference with the narrowest
    routing decision of the prompt's first layer resolved the other way:
    the clear gaps show the shift, the settled ones find the decision and
    read none."""
    from portbench.reference import model as ref
    cfg = dict(MAN.config("mixtral-8x7b"), **TINY_CONFIG)
    params, scorer = weights.make(cfg, seed, "cpu")
    gen = torch.Generator().manual_seed(seed % 2 ** 31)
    prompt = torch.randint(0, 25, (8,), generator=gen).tolist()
    probe = {"prompt": prompt, "scores": [],
             "out": torch.randint(0, 25, (40,), generator=gen).tolist()}
    lm = []
    ref.hidden_states(cfg, params, [prompt + probe["out"]], layer_margins=lm)
    narrow = lm[0][:, :len(prompt)]
    l, t = 0, int(narrow[0].argmin())
    h = ref.hidden_states(cfg, params, [prompt + probe["out"]],
                          flips={l: torch.tensor([t])})[0]
    probe["confs"] = C._ref_logp(cfg, params, probe, h)["logp"].exp().tolist()
    monkeypatch.setattr(C, "NEAR_TIE", float(narrow[l, t]) * 1.001)
    trail = []
    got = C.summarize(C.series(cfg, params, scorer, [probe], trail=trail))
    assert got["logprob_err_clear_p90"] > 1e-3
    assert got["logprob_err_settled_p90"] < 1e-5
    assert [(x["layer"], x["pos"]) for x in trail if x["kept"]] == [(l, t)]
