"""Multi-process helpers of the port's mesh tests: spawn a gloo group of
CPU ranks and run the mesh engine's scenarios in each. No jax here: the
ranks import only the port.

Each rank pins one intra-op thread, joins a default group through a file
store in the test's own directory (no TCP port), and writes what it
returns to ``rank<r>.pt`` there; :func:`spawn` reads them back in rank
order. A rank that raises fails the spawn with its traceback.
"""
import contextlib
import dataclasses
import datetime
import io
import os

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

MAX_NEW = 24
BATCH = 8
PROMPTS = ("3+5-2=", "7*2+1=", "9-4+6=", "1+2-3+4-5+6-7+8=")
LONG = 3       # the prompt of four chunks of 4 (two of 8)
TIGHT = 4      # the tight-pool prompt of tests/test_torch_engine_paths.py


def _entry(rank, world, path, target, args):
    torch.set_num_threads(1)
    # a rank left waiting in a collective fails the spawn within 2 minutes
    dist.init_process_group("gloo", init_method=f"file://{path}/store",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=120))
    try:
        out = globals()[target](*args)
        torch.save(out, os.path.join(path, f"rank{rank}.pt"))
        dist.barrier()
    finally:
        dist.destroy_process_group()


def spawn(world: int, path: str, target: str, *args) -> list:
    """Run ``target(*args)`` (a function of this module) on ``world``
    gloo ranks; returns each rank's result, by rank."""
    os.makedirs(path, exist_ok=True)
    mp.spawn(_entry, args=(world, str(path), target, args), nprocs=world,
             join=True)
    return [torch.load(os.path.join(path, f"rank{r}.pt"), weights_only=False)
            for r in range(world)]


# ---------------------------------------------------------------------------
# serving scenarios: the same requests through a single-device engine and
# through each rank of a mesh engine
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Scenario:
    K: int = 1
    temperature: float = 0.8
    num_blocks: int = 64
    chunk: object = None
    kv_dtype: str = "f32"
    use_kernel: object = False
    method: str = "step"
    prompts: tuple = (0,)          # indices of prompt_tokens
    n_traces: int = 4
    waves: int = 1                 # serves of the same requests
    max_new: int = MAX_NEW
    arrivals: tuple = ()           # per-request arrival times (online)
    bf16: bool = False             # bf16 params (else f32)


SCENARIOS = {
    "k1_greedy": Scenario(temperature=0.0, prompts=(0,), n_traces=6),
    "k1_sampled": Scenario(prompts=(2,), n_traces=5),
    "k4_sampled": Scenario(K=4, prompts=(1,), n_traces=4),
    "chunk8_sampled": Scenario(chunk=8, prompts=(LONG,), n_traces=3),
    "chunk8_k4_greedy": Scenario(K=4, chunk=8, temperature=0.0,
                                 prompts=(LONG,), n_traces=4),
    # the tight pool: STEP prunes, SC preempts
    "tight_step": Scenario(num_blocks=12, max_new=48, prompts=(TIGHT,),
                           n_traces=8),
    "tight_sc": Scenario(num_blocks=12, max_new=48, prompts=(TIGHT,),
                         n_traces=8, method="sc"),
    # two requests, served twice: the second serve hits the prefix cache
    "multi_prefix": Scenario(K=4, chunk=8, prompts=(LONG, 0), n_traces=3,
                             waves=2),
    "int8": Scenario(kv_dtype="int8", chunk=4, prompts=(LONG,), n_traces=4),
    "kernel": Scenario(K=2, use_kernel=True, prompts=(0,), n_traces=4,
                       max_new=16),
    "kernel_chunk8": Scenario(chunk=8, use_kernel=True, prompts=(LONG,),
                              n_traces=3, max_new=16),
    # online: the second request arrives while the first decodes
    "online": Scenario(temperature=0.0, prompts=(0, 2), n_traces=3,
                       arrivals=(0.0, 0.05)),
    # greedy through the kernels, chunked: the card's mesh test
    "kernel_greedy": Scenario(K=4, chunk=8, temperature=0.0, use_kernel=True,
                              prompts=(LONG, 0), n_traces=4, max_new=16),
    "bf16_greedy": Scenario(K=4, chunk=8, temperature=0.0, kv_dtype="bf16",
                            bf16=True, prompts=(LONG, 1), n_traces=3),
}


def setup(params_path: str):
    """(cfg, params, scorer, tokenizer) from the parent's file."""
    from repro_torch.configs.registry import serving_config
    from repro_torch.data.tokenizer import get_tokenizer
    state = torch.load(params_path, weights_only=False)
    return serving_config(), state["params"], state["scorer"], get_tokenizer()


def prompt_tokens(i: int, tok) -> list:
    if i == TIGHT:
        from repro_torch.data.arithmetic import make_prompt
        from repro_torch.serving.evaluate import make_problems
        return tok.encode(make_prompt(make_problems(3, seed=11)[0]),
                          add_bos=True)
    return tok.encode(PROMPTS[i], add_bos=True)


def to_bf16(tree: dict) -> dict:
    return {k: to_bf16(v) if isinstance(v, dict) else v.bfloat16()
            for k, v in tree.items()}


def make_engine(sc: Scenario, params, cfg, scorer, mesh=None, device="cpu",
                **kw):
    from repro_torch.core.pruning import make_policy
    from repro_torch.serving.engine import Engine, EngineConfig
    from repro_torch.serving.sampling import SamplingParams
    greedy = sc.temperature == 0.0
    fields = dict(
        max_batch=BATCH, num_blocks=sc.num_blocks, capacity=128,
        max_new_tokens=sc.max_new,
        sampling=SamplingParams(temperature=sc.temperature,
                                top_k=0 if greedy else 20,
                                top_p=1.0 if greedy else 0.95,
                                max_new_tokens=sc.max_new),
        prefill_chunk_size=sc.chunk, decode_horizon=sc.K,
        use_kernel=sc.use_kernel, kv_dtype=sc.kv_dtype, faults=None,
        prefix_cache=True)
    ecfg = EngineConfig(**{**fields, **kw})
    return Engine(params, cfg, ecfg, make_policy(sc.method),
                  scorer_params=scorer, mesh=mesh, device=device)


def summarize(results) -> list:
    """What a serve decided and produced, as plain values."""
    return [{"request_id": r.request_id, "status": r.status,
             "answer": r.answer, "num_pruned": r.num_pruned,
             "num_preemptions": r.num_preemptions,
             "cached_tokens": r.metrics.cached_tokens,
             "traces": [(t.output_tokens, t.step_scores, t.token_confidences,
                         str(t.status)) for t in r.traces]}
            for r in results]


def run_scenario(name: str, params, cfg, scorer, tok, mesh=None,
                 device="cpu") -> dict:
    """Serve scenario ``name`` on ``device``; returns the summaries of its
    waves and whether the engine ran the kernel route."""
    from repro_torch.core.pruning import make_policy
    from repro_torch.serving.engine import Request
    sc = SCENARIOS[name]
    if sc.bf16:
        params = to_bf16(params)
    eng = make_engine(sc, params, cfg, scorer, mesh, device)
    prompts = [prompt_tokens(i, tok) for i in sc.prompts]
    out = []
    for _ in range(sc.waves):
        reqs = [Request(request_id=i, prompt_tokens=list(p),
                        n_traces=sc.n_traces, policy=make_policy(sc.method),
                        arrival_time=(sc.arrivals[i] if sc.arrivals else 0.0))
                for i, p in enumerate(prompts)]
        out.append(summarize(eng.serve_batch(reqs)))
        assert eng.pool_drained()
        eng.block_mgr.check_invariants()
    return {"waves": out, "use_kernel": eng.use_kernel,
            "fused_scorer": eng.fused_scorer}


def mesh_scenarios(params_path: str, shapes: dict,
                   device: str = "cpu") -> dict:
    """In a rank: for each ``key: (shape, names)`` of ``shapes`` (meshes
    over the same ranks), every scenario of ``names`` through the mesh
    engine on a ``shape`` mesh (ranks on ``device``; the kernel launches
    counted per scenario), then, on the CPU, the checks that need a
    mesh."""
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_host_mesh
    cfg, params, scorer, tok = setup(params_path)
    runs = {}
    for key, (shape, names) in shapes.items():
        mesh = make_host_mesh(*shape)
        out = runs[key] = {}
        for name in names:
            ops.reset_launch_counts()
            out[name] = run_scenario(name, params, cfg, scorer, tok, mesh,
                                     device)
            out[name]["launches"] = ops.launch_counts()
        if device == "cpu":
            out["_checks"] = mesh_checks(mesh, shape, params, cfg, scorer,
                                         tok)
    return runs


def _raises(fn) -> str:
    try:
        fn()
    except (ValueError, NotImplementedError, RuntimeError) as e:
        return f"{type(e).__name__}: {e}"
    return "no error"


def mesh_checks(mesh, shape, params, cfg, scorer, tok) -> dict:
    """The gates, the shards a rank keeps, and the agreement check."""
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.serving.engine import Request
    base = Scenario(temperature=0.0, max_new=8)
    checks = {}
    eng = make_engine(base, params, cfg, scorer, mesh)
    checks["wq_local"] = tuple(eng.params["layers"]["attn"]["wq"].shape)
    checks["embed_local"] = tuple(eng.params["embed"].shape)
    checks["w_down_local"] = tuple(eng.params["layers"]["mlp"]["w_down"]
                                   .shape)
    checks["kv_heads_local"] = eng._kv_heads
    checks["wq_slice_equal"] = bool(torch.equal(
        eng.params["layers"]["attn"]["wq"],
        params["layers"]["attn"]["wq"].chunk(shape[1], dim=-1)[
            eng.tp.model_rank]))
    # the rank-agreement check: one rank's serve made to differ
    res = eng.serve_batch([Request(request_id=0,
                                   prompt_tokens=prompt_tokens(0, tok),
                                   n_traces=2)])
    if dist.get_rank() == dist.get_world_size() - 1:
        res[0].traces[0].output_tokens.append(0)
    checks["tampered"] = _raises(lambda: eng.check_ranks_agree(res))
    if shape == (2, 2):
        checks["batch_6"] = _raises(lambda: make_engine(
            base, params, cfg, scorer, make_host_mesh(4, 1), max_batch=6))
        gates = {
            "ssm": dataclasses.replace(cfg, arch_type="ssm"),
            "hybrid": dataclasses.replace(cfg, arch_type="hybrid"),
            "encdec": dataclasses.replace(cfg, is_encoder_decoder=True),
            "mla": dataclasses.replace(cfg, use_mla=True),
            "moe": dataclasses.replace(cfg, num_experts=4,
                                       num_experts_per_tok=2),
        }
        for key, c in gates.items():
            checks[f"refuse_{key}"] = _raises(lambda c=c: make_engine(
                dataclasses.replace(base, kv_dtype="bf16"), params, c,
                scorer, mesh))
    if shape == (1, 4):
        kernel = dataclasses.replace(base, use_kernel=True)
        checks["kernel_true"] = _raises(lambda: make_engine(
            kernel, params, cfg, scorer, mesh))
        auto = make_engine(dataclasses.replace(base, use_kernel="auto"),
                           params, cfg, scorer, mesh)
        checks["kernel_auto"] = auto.use_kernel
    return checks


def serve_cli(art_dir: str, argvs: list) -> list:
    """In a rank: ``repro_torch.launch.serve.main(argv)`` over the
    default group for each of ``argvs``, its standard output and how it
    exited."""
    from repro_torch.launch import artifacts, serve
    artifacts.ART_DIR = art_dir
    out = []
    for argv in argvs:
        buf = io.StringIO()
        exit_msg = None
        with contextlib.redirect_stdout(buf):
            try:
                serve.main(argv)
            except SystemExit as e:
                exit_msg = str(e)
        out.append({"stdout": buf.getvalue(), "exit": exit_msg})
    return out


# ---------------------------------------------------------------------------
# the checks both mesh test files make of the ranks' results
# ---------------------------------------------------------------------------

def assert_like_single(want: dict, ranks: list, name: str) -> None:
    """Every rank's serve of scenario ``name`` equals the single-device
    engine's ``want`` exactly, and the scenario shows what it is for."""
    for rank, out in enumerate(ranks):
        got = out[name]
        assert got["waves"] == want["waves"], f"rank {rank} differs"
        assert got["use_kernel"] is want["use_kernel"] \
            is name.startswith("kernel")
        assert got["fused_scorer"] is False   # dense scorer on a mesh
    waves = want["waves"]
    if name == "tight_step":
        assert waves[0][0]["num_pruned"] > 0
        assert waves[0][0]["num_preemptions"] == 0
    if name == "tight_sc":
        assert waves[0][0]["num_preemptions"] > 0
    if name == "multi_prefix":   # the second serve hits the prefix cache
        assert waves[1][0]["cached_tokens"] > 0
    if name == "online":         # both arrivals served
        assert [r["status"] for r in waves[0]] == ["completed"] * 2


def assert_shards(ranks: list, model: int) -> None:
    """Each rank keeps its shards of the serving config's params (4 query
    heads over 2 kv heads at hd 64, d 256, vocab padded to 256), and its
    agreement check raised when the last rank's results were changed."""
    for out in ranks:
        c = out["_checks"]
        assert c["wq_local"] == (2, 256, 256 // model)   # column-parallel
        assert c["embed_local"] == (256 // model, 256)   # vocab rows
        assert c["w_down_local"] == (2, 512, 256)        # whole
        assert c["kv_heads_local"] == (1 if model == 2 else 2)
        assert c["wq_slice_equal"]
        assert c["tampered"].startswith(
            "RuntimeError: the mesh's ranks disagree")


# ---------------------------------------------------------------------------
# the dry run's partitioning rules (``launch.spmd``): each rule's result
# on a (data 2, model 2) mesh against the plain op on the whole tensors
# ---------------------------------------------------------------------------

def spmd_rule_values() -> dict:
    """name -> (the rule's result gathered whole, the plain op's, the
    result's placements as text), for each rule of ``launch.spmd`` on
    operands laid out over a (2, 2) mesh. Every rank builds the same
    whole tensors from one seed."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import (Replicate, Shard,
                                          distribute_tensor)
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.launch.spmd import SpmdRules
    from repro_torch.models.layers import contiguous_kv_update

    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    g = torch.Generator().manual_seed(0)
    R_, S0, S1, S2 = Replicate(), Shard(0), Shard(1), Shard(2)

    def rand(*shape):
        return torch.randn(*shape, generator=g)

    def lay(t, *pl):
        return distribute_tensor(t, mesh, list(pl))

    x16, x32 = rand(4, 8, 16), rand(4, 8, 32)
    w16_32, w32_16, we = rand(16, 32), rand(32, 16), rand(2, 16, 32)
    xe = rand(2, 8, 16)
    q, k = rand(4, 4, 8, 16), rand(4, 4, 8, 16)
    table = rand(32, 16)
    tokens = torch.randint(0, 32, (4, 8), generator=g)
    logits, row = rand(4, 32), rand(1, 32)
    gold = torch.randint(0, 32, (4, 1), generator=g)
    x48, x64, scale = rand(4, 8, 48), rand(4, 8, 64), rand(16)
    cache, new = rand(4, 8, 2, 16), rand(4, 2, 16)
    slot = torch.tensor([7, 0, 3, 5])
    probs, vals = rand(4, 4, 16, 8), rand(4, 4, 8, 4)

    cases = {
        "product_column_parallel": (
            lambda: lay(x16, S0, S2) @ lay(w16_32, R_, S1), x16 @ w16_32),
        "product_row_parallel": (
            lambda: lay(x32, S0, S2) @ lay(w32_16, R_, S0), x32 @ w32_16),
        "product_fsdp": (
            lambda: lay(x16, S0, R_) @ lay(w16_32, S0, S1), x16 @ w16_32),
        "product_experts": (
            lambda: lay(xe, R_, R_) @ lay(we, R_, S0), xe @ we),
        "einsum_batch_heads": (
            lambda: torch.einsum("bhqd,bhkd->bhqk", lay(q, S0, S1),
                                 lay(k, S0, S1)),
            torch.einsum("bhqd,bhkd->bhqk", q, k)),
        "einsum_split_letters": (
            lambda: torch.einsum("bhqk,bhkd->bhqd", lay(probs, S0, S1),
                                 lay(vals, S0, Shard(3))),
            torch.einsum("bhqk,bhkd->bhqd", probs, vals)),
        "lookup_vocab_rows": (
            lambda: lay(table, R_, S0)[lay(tokens, S0, R_)], table[tokens]),
        "lookup_fsdp": (
            lambda: lay(table, S1, S0)[lay(tokens, S0, R_)], table[tokens]),
        "gather_vocab": (
            lambda: torch.gather(lay(logits, S0, S1), 1, lay(gold, S0, R_)),
            torch.gather(logits, 1, gold)),
        "logsumexp_vocab": (
            lambda: torch.logsumexp(lay(logits, S0, S1), -1),
            torch.logsumexp(logits, -1)),
        "argmax_vocab": (
            lambda: torch.argmax(lay(logits, S0, S1), -1),
            torch.argmax(logits, -1)),
        "argmax_batch_of_one": (
            lambda: torch.argmax(lay(row, R_, S1), -1),
            torch.argmax(row, -1)),
        "reshape_heads": (
            lambda: lay(x64, S0, S2).reshape(4, 8, 4, 16),
            x64.reshape(4, 8, 4, 16)),
        "reshape_gathered": (
            lambda: lay(x48, S0, S2).reshape(4, 8, 3, 16),
            x48.reshape(4, 8, 3, 16)),
        "scale_follows_activation": (
            lambda: lay(x16, S0, S2) * lay(scale, R_, R_), x16 * scale),
        "scale_gathered": (
            lambda: lay(x16, S0, R_) + lay(scale, R_, S0), x16 + scale),
    }
    want = cache.clone()
    want[torch.arange(4), slot] = new
    for name, pl in {"write_rows_and_slots": (S0, S1),
                     "write_slots_and_heads": (S1, S2),
                     "write_slots_twice": (S1, S1)}.items():
        def write(pl=pl):
            c = lay(cache.clone(), *pl)
            contiguous_kv_update(c, lay(slot, S0, R_), lay(new, S0, R_))
            return c
        cases[name] = (write, want)

    out = {}
    for name, (rule, plain) in cases.items():
        with implicit_replication(), SpmdRules():
            got = rule()
        out[name] = (got.full_tensor(), plain, str(tuple(got.placements)))
    return out
