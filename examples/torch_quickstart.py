"""Quickstart on the PyTorch port: the full STEP pipeline at laptop
scale, end to end (``examples/quickstart.py``, ported).

    PYTHONPATH=src python examples/torch_quickstart.py            # the card
    PYTHONPATH=src python examples/torch_quickstart.py --device cpu

1. trains a tiny reasoning LM on the synthetic verifiable task;
2. samples solutions from it, verifies them, trains the hidden-state
   step scorer (paper §4.1);
3. serves one problem with self-consistency (baseline) vs STEP under a
   tight KV-pool budget and prints the latency/waiting comparison
   (paper §4.2/§5.3.4).

``--steps`` sets the LM's training steps (300, as the JAX example). The
engines run the paged attention and the step scorer through the CUDA
kernels on the card (``use_kernel="auto"``; the dense path on the CPU).
``--chunk N`` prefills prompts in chunks of N tokens (through the paged
prefill kernel) where the JAX example prefills them whole.
"""
import argparse
import random

from repro_torch.configs.registry import serving_config
from repro_torch.core import make_policy
from repro_torch.core.pipeline import build_step_scorer
from repro_torch.data.arithmetic import gen_problem, make_prompt
from repro_torch.data.tokenizer import get_tokenizer
from repro_torch.serving import Engine, EngineConfig, SamplingParams
from repro_torch.training.trainer import TrainConfig, train_lm


def main(argv=None) -> dict:
    """Runs the three steps; returns ``{"sc": result, "step": result}``
    (the engines' ``RequestResult``s)."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--chunk", type=int, default=None)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    cfg = serving_config()

    print("== 1. train the reasoning LM (tiny, synthetic task) ==")
    params, _ = train_lm(cfg, TrainConfig(steps=args.steps, seq_len=128,
                                          batch_size=16, log_every=50),
                         device=args.device)

    print("== 2. sample -> verify -> train the step scorer ==")
    scorer, info = build_step_scorer(params, cfg, n_problems=16,
                                     n_samples=4, per_class=24, verbose=True)
    print(f"   scorer trained on {info['num_steps']} boundary states "
          f"(sampled correct-rate {info['sampled_correct_rate']:.2f})")

    print("== 3. SC vs STEP under a tight KV pool ==")
    tok = get_tokenizer()
    problem = gen_problem(random.Random(7), (4, 6))
    prompt = tok.encode(make_prompt(problem), add_bos=True)
    ecfg = EngineConfig(max_batch=8, num_blocks=12, capacity=128,
                        max_new_tokens=96,
                        sampling=SamplingParams(max_new_tokens=96),
                        use_kernel="auto",
                        prefill_chunk_size=args.chunk)
    results = {}
    for method in ("sc", "step"):
        policy = make_policy(method)
        eng = Engine(params, cfg, ecfg, policy,
                     scorer_params=scorer if policy.uses_scorer else None,
                     device=args.device)
        res = results[method] = eng.serve(prompt, 8)
        ok = res.answer is not None and int(res.answer) == problem.answer
        print(f"   {method:4s}: answer={res.answer} (gold={problem.answer}, "
              f"{'OK' if ok else 'WRONG'})  latency={res.latency_s:.2f}s  "
              f"wait={res.wait_s:.2f}s  pruned={res.num_pruned}  "
              f"preemptions={res.num_preemptions}")
    return results


if __name__ == "__main__":
    main()
