"""Tiny stand-ins for the CPU tests: a configuration and a mix small
enough to serve on the CPU in seconds, over a cell's own files."""

TINY_CONFIG = {"num_layers": 2, "d_model": 64, "num_heads": 4,
               "num_kv_heads": 2, "head_dim": 16, "d_ff": 128,
               "vocab_size": 256, "num_blocks": 40, "moe_d_ff": 96}

TINY_MIX = {"traces": 4, "max_new_tokens": 24, "problems": 400,
            "engine": {"max_batch": 4, "decode_horizon": 4, "capacity": 64,
                       "prefill_chunk_size": None, "prefix_cache": True},
            "profile_ticks": 3}

TINY_OPEN = dict(TINY_MIX, rate_per_s=4.0,
                 prefix={"examples": 2, "steps": [3, 3], "seed": 8},
                 engine={"max_batch": 8, "decode_horizon": 4, "capacity": 160,
                         "prefill_chunk_size": 32, "prefix_cache": True})


def run_tiny(cell: str, seed: int = 2 ** 31 + 7, seconds: float = 1.0,
             trace: bool = False, **kw) -> dict:
    from portbench import run
    mix = TINY_OPEN if "fewshot" in cell else TINY_MIX
    return run.run_cell(cell, seed, seconds, trace, device="cpu",
                        config_override=TINY_CONFIG, mix_override=mix, **kw)
