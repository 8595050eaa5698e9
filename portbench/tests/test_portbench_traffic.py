"""The general generator: the same seed gives the same problems, another
seed other problems of the same sizes and arrivals."""
import pytest

from portbench import frozen, manifest as M, traffic

MAN = M.Manifest()
MIXES = ["step-n64", "fewshot-open"]
SEEDS = (2 ** 31 + 5, 3 * 10 ** 9 + 11)


def key(problems):
    return [(p.prompt, p.arrival_s, p.n_traces, p.max_new_tokens)
            for p in problems]


@pytest.mark.parametrize("name", MIXES)
def test_deterministic_per_seed(name):
    mix = MAN.traffic(name)
    assert key(traffic.problems(mix, SEEDS[0], 51)) == \
        key(traffic.problems(mix, SEEDS[0], 51))


@pytest.mark.parametrize("name", MIXES)
def test_seeds_differ_in_order_not_in_work(name):
    mix = MAN.traffic(name)
    a, b = (traffic.problems(mix, s, 51) for s in SEEDS)
    assert [p.prompt for p in a] != [p.prompt for p in b]
    assert sorted(len(p.prompt) for p in a) == sorted(len(p.prompt) for p in b)
    assert [p.arrival_s for p in a] == [p.arrival_s for p in b]


def test_open_loop_keeps_its_rate():
    mix = MAN.traffic("fewshot-open")
    probs = traffic.problems(mix, SEEDS[0], 51)
    assert len(probs) == int(mix["rate_per_s"] * 51)
    span = probs[-1].arrival_s + (probs[-1].arrival_s / (len(probs) - 1))
    assert span == pytest.approx(len(probs) / mix["rate_per_s"], rel=0.05)


def test_fewshot_prefix_is_shared_and_about_1k_tokens():
    mix = MAN.traffic("fewshot-open")
    probs = traffic.problems(mix, SEEDS[0], 51)
    head = frozen.encode(traffic.prefix_text(mix), add_bos=True)
    assert 900 <= len(head) <= 1100
    assert all(p.prompt[:len(head)] == head for p in probs)
    tails = [len(p.prompt) - len(head) for p in probs]
    assert 16 <= min(tails) and max(tails) <= 66


def test_tokenizer_copy_round_trips():
    text = "3+5-2=<think>3+5=8\n\n8-2=6\n\n</think>boxed{6}"
    ids = frozen.encode(text)
    assert frozen.decode(ids) == text
    assert frozen.STEP_ID in ids
    assert frozen.extract_answer(frozen.decode(ids)) == "6"
