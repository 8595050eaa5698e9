"""Per-device cost of a step, counted op by op as it runs: the port's
counterpart of ``repro/launch/hlo_analysis.py``.

The JAX package lowers a step to its per-device SPMD HLO and parses the
text: every computation into a symbol table, ``while`` bodies weighted
by their trip counts, the dots' flops, the HBM bytes at fusion
boundaries, the collectives' result bytes. The port has no HLO to parse.
It runs the step once, eagerly, under :class:`CostCounter`, a
``TorchDispatchMode`` that sees every aten op:

  * **Per device.** Over DTensors (the dry run's params, inputs and
    caches, laid out on a mesh of a fake process group), the counter
    lets each DTensor op through to DTensor's own dispatch and counts
    the ops that this dispatch runs on the LOCAL shards of rank 0, and
    the collectives it issues to redistribute them. So each number is
    one rank's share, as the per-device HLO module's are. (A DTensor op
    is the global op: counting it would give the whole mesh's flops.)
    The global-shape ops that DTensor runs on fake tensors to propagate
    shapes are not counted. Over plain tensors the counter counts the
    ops as they are: one device's program.
  * **No trip counts.** A Python loop over layers or chunks runs each
    trip, so the counter sees each one; nothing is weighted.
  * **flops**: PyTorch's flop formulas (``torch.utils.flop_counter``)
    of each product (mm, bmm, addmm, baddbmm, convolutions, fused
    attention). An ``einsum`` reaches the counter as its bmm.
  * **bytes**: the operand and result bytes of each aten op on the local
    tensors. View and shape ops (the reference's ``_SHAPE_ONLY``) and
    uninitialised allocations move nothing and are skipped; a gather
    reads its result's rows and the indices; a scatter or an indexed
    write touches its update twice and the indices, as the reference
    counts ``gather``/``scatter``/``dynamic-update-slice``. This is the
    traffic of the EAGER port, op by op and unfused: an elementwise
    chain that XLA fuses into one pass counts here once per op. It is
    an upper bound on what a fused program moves.
  * **score_bytes**: with ``score_seq_len`` S, the bytes of ops whose
    result or an operand is attention-score shaped ([..., S, c] with
    0 < c <= S), which a flash kernel keeps on chip.
  * **collectives**: the result bytes of each ``c10d_functional``
    collective, by the reference's kinds (``all-gather``, ``all-reduce``,
    ``reduce-scatter``, ``all-to-all``). On a mesh of the ``cpu`` device
    type (the dry run's), DTensor turns a shard-to-shard redistribution,
    an all-to-all on a GPU mesh, into an all-gather and a chunk. The
    counter finds those gathers by their caller, counts each as the
    ``all-to-all`` it stands for (its result bytes: the input's), and
    says how many it so counted in ``all_to_all_from_all_gather``.
  * **peak_live_bytes**: the most bytes that the tensors the step
    allocates (not its arguments) held at once, tracked through their
    storages: the counterpart of XLA's ``temp_size_in_bytes``.

:func:`roofline_terms` keeps the reference's signature and its
``dominant`` rule, at the H100's peaks.
"""
from __future__ import annotations

import sys
import weakref
from typing import Dict, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

# NVIDIA H100 SXM (80GB HBM3, 700 W), per GPU, from NVIDIA's data sheet
PEAK_FLOPS = 989e12          # bf16 dense FLOP/s on the tensor cores
HBM_BW = 3.35e12             # bytes/s
# With 8 GPUs to an NVLink domain (450e9 B/s per direction within a
# node), both 16-wide axes of the production meshes cross nodes, so
# every collective is bounded by the network: one 400 Gb/s NDR port per
# GPU.
LINK_BW = 50e9               # bytes/s

_COLLECTIVES = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
}
_C10D = ("_c10d_functional", "_c10d_functional_autograd")

# ops that read a result's worth of rows through indices
_GATHERS = {"index.Tensor", "gather.default", "embedding.default",
            "index_select.default"}
# ops that write an update through indices (the rest of self untouched)
_SCATTERS = {"index_put.default", "index_put_.default",
             "_index_put_impl_.default", "scatter.src", "scatter_.src",
             "scatter_add.default", "scatter_add_.default",
             "index_add.default", "index_add_.default",
             "index_copy.default", "index_copy_.default"}
# allocations that write nothing
_UNINITIALISED = {"empty.memory_format", "empty_strided.default",
                  "empty_like.default", "new_empty.default",
                  "new_empty_strided.default"}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(tree):
    return [x for x in tree_flatten(tree)[0] if isinstance(x, torch.Tensor)]


def _called_from(name: str) -> bool:
    frame = sys._getframe(2)
    while frame is not None:
        if frame.f_code.co_name == name:
            return True
        frame = frame.f_back
    return False


class CostCounter(TorchDispatchMode):
    """Counts the ops run under it (see the module docstring)."""

    def __init__(self, score_seq_len: Optional[int] = None):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        self._flop_formulas = flop_registry
        self.score_seq_len = score_seq_len
        self.flops = 0.0
        self.bytes = 0.0
        self.score_bytes = 0.0
        self.collectives: Dict[str, float] = {}
        self.all_to_all_from_all_gather = 0
        self.ops = 0
        self.live_bytes = 0
        self.peak_live_bytes = 0
        self._storages: "weakref.WeakSet" = weakref.WeakSet()

    def _free(self, n: int) -> None:
        self.live_bytes -= n

    def _track(self, outs, ins) -> None:
        """Count the new storages among ``outs`` as live until freed."""
        held = {id(t.untyped_storage()) for t in ins}
        for t in outs:
            st = t.untyped_storage()
            if id(st) in held or st in self._storages:
                continue
            self._storages.add(st)
            n = st.nbytes()
            weakref.finalize(st, self._free, n)
            self.live_bytes += n
        self.peak_live_bytes = max(self.peak_live_bytes, self.live_bytes)

    def _is_score(self, t: torch.Tensor) -> bool:
        S = self.score_seq_len
        return (S is not None and t.dim() >= 2 and t.shape[-2] == S
                and 0 < t.shape[-1] <= S)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            # DTensor's dispatch runs the local ops (and collectives) with
            # this mode still active: those are what a rank executes
            return NotImplemented
        try:
            out = func(*args, **kwargs)
        except Exception as err:    # name the local op that failed
            err.add_note(f"in {func} on a rank's local shards")
            raise
        from torch._subclasses.fake_tensor import FakeTensor
        ins, outs = _tensors((args, kwargs)), _tensors(out)
        if any(isinstance(t, FakeTensor) for t in ins + outs):
            return out      # DTensor's shape propagation, at global shape
        self._count(func, args, kwargs, out, ins, outs)
        return out

    def _count(self, func, args, kwargs, out, ins, outs) -> None:
        self.ops += 1
        ns = func.namespace
        name = func._opname if ns in _C10D else \
            f"{func._opname}.{func._overloadname}"
        if ns in _C10D:
            kind = _COLLECTIVES.get(name)
            if kind is None:       # wait_tensor and friends move nothing
                return
            res = sum(_nbytes(t) for t in outs)
            if kind == "all-gather" and _called_from("shard_dim_alltoall"):
                kind, res = "all-to-all", sum(_nbytes(t) for t in ins)
                self.all_to_all_from_all_gather += 1
            self.collectives[kind] = self.collectives.get(kind, 0.0) + res
            self.bytes += res + sum(_nbytes(t) for t in ins)
            self._track(outs, ins)
            return
        if func.is_view:
            return
        if name in _UNINITIALISED:
            self._track(outs, ins)
            return
        formula = self._flop_formulas.get(func.overloadpacket)
        if formula is not None:
            self.flops += formula(*args, **kwargs, out_val=out)
        if name in _GATHERS:
            b = 2 * sum(_nbytes(t) for t in outs) + sum(
                _nbytes(t) for t in ins[1:] if not t.is_floating_point())
        elif name in _SCATTERS:
            vals = [t for t in ins[1:] if t.is_floating_point()]
            idx = [t for t in ins[1:] if not t.is_floating_point()]
            b = 2 * sum(map(_nbytes, vals)) + sum(map(_nbytes, idx))
        else:
            b = sum(map(_nbytes, ins)) + sum(map(_nbytes, outs))
        self.bytes += b
        if any(map(self._is_score, ins + outs)):
            self.score_bytes += b
        self._track(outs, ins)

    def result(self) -> dict:
        return {"flops": self.flops, "bytes": self.bytes,
                "score_bytes": self.score_bytes,
                "collective_breakdown": dict(self.collectives),
                "collective_bytes": float(sum(self.collectives.values())),
                "all_to_all_from_all_gather": self.all_to_all_from_all_gather,
                "peak_live_bytes": self.peak_live_bytes,
                "ops": self.ops}


def op_cost(fn, *args, score_seq_len: Optional[int] = None) -> dict:
    """Run ``fn(*args)`` once under a :class:`CostCounter` and return its
    per-device cost: the keys of the reference's ``hlo_cost``
    (``flops``, ``bytes``, ``score_bytes``, ``collective_breakdown``,
    ``collective_bytes``), and ``all_to_all_from_all_gather``,
    ``peak_live_bytes`` and ``ops`` (the aten ops counted)."""
    counter = CostCounter(score_seq_len=score_seq_len)
    with counter:
        fn(*args)
    return counter.result()


def roofline_terms(flops: float, hbm_bytes: float, coll_bytes: float,
                   chips: int = 1) -> Dict[str, float]:
    """The three roofline times (seconds) and the dominant one. Pass
    per-device numbers with ``chips=1``."""
    t_compute = flops / (chips * PEAK_FLOPS)
    t_memory = hbm_bytes / (chips * HBM_BW)
    t_coll = coll_bytes / (chips * LINK_BW)
    dominant = max(
        (("compute", t_compute), ("memory", t_memory),
         ("collective", t_coll)), key=lambda kv: kv[1])[0]
    return {"t_compute_s": t_compute, "t_memory_s": t_memory,
            "t_collective_s": t_coll, "dominant": dominant}
