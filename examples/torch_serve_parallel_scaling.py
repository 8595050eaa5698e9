"""End-to-end serving on the PyTorch port: evaluate all five
methods (CoT / SC / Slim-SC / DeepConf / STEP) on a batch of problems
with the cached artifacts, reproducing the paper's Table-1 metric triple
(accuracy / tokens / latency) at laptop scale
(``examples/serve_parallel_scaling.py``, ported).

    PYTHONPATH=src python examples/torch_serve_parallel_scaling.py \\
        [--device cpu]

The artifacts (the trained LM and its step scorer) load through
``repro_torch.launch.artifacts.load_artifacts``, which builds them on
first use (``REPRO_TRAIN_STEPS`` training steps, default 4000).
``--problems`` and ``--traces`` default to the JAX example's 6 and 16.
"""
import argparse

from repro_torch.launch.artifacts import load_artifacts
from repro_torch.serving import (EngineConfig, SamplingParams,
                                 evaluate_method, make_problems)

N_PROBLEMS = 6
N_TRACES = 16


def main(argv=None) -> dict:
    """Evaluates the five methods; returns ``{method: EvalResult}``."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--problems", type=int, default=N_PROBLEMS)
    ap.add_argument("--traces", type=int, default=N_TRACES)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    params, scorer, cfg = load_artifacts(device=args.device)
    problems = make_problems(args.problems, seed=7, n_steps=(5, 8))
    ecfg = EngineConfig(max_batch=args.traces, num_blocks=40, capacity=256,
                        max_new_tokens=120,
                        sampling=SamplingParams(max_new_tokens=120))
    print(f"{'method':10s} {'acc':>5s} {'tokens':>8s} {'lat(s)':>7s} "
          f"{'wait(s)':>8s} {'pruned':>6s} {'preempt':>7s}")
    results = {}
    for method in ("cot", "sc", "slimsc", "deepconf", "step"):
        pkw = {"warmup": 4} if method == "deepconf" else {}
        res = results[method] = evaluate_method(
            method, params, cfg, problems, args.traces, ecfg,
            scorer_params=scorer, policy_kwargs=pkw, device=args.device)
        print(f"{method:10s} {res.accuracy:5.2f} {res.avg_tokens:8.0f} "
              f"{res.avg_latency_s:7.2f} {res.total_wait_s:8.2f} "
              f"{res.num_pruned:6d} {res.num_preemptions:7d}")
    return results


if __name__ == "__main__":
    main()
