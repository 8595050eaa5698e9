"""The dry run's partitioning rules: where DTensor's choice for an op
differs from what XLA's SPMD partitioner does with the reference's
layout, :class:`SpmdRules` lays the op's operands out as the partitioner
would and runs it on the local shards.

DTensor picks each op's layout greedily, from that op's inputs alone;
the partitioner propagates the layouts over the whole program. Over the
Megatron layout of the training dry run (the residual stream split over
"model" on D between layers, the weights split over "model" and, for
FSDP, over "data"), and over the serving caches, the two part in these
places, each a rule here:

  * **Products with a weight** (``x @ w``, w [K, N], or stacked over
    batch dims it shares with x, as the experts'): the weight stays
    where it is, as far as it can. An activation split along the
    contraction over a mesh dim where the weight is not is gathered
    (the all-gather before a column-parallel product); an activation
    whole along it is split (free; the product's output is a partial
    sum, reduced where it is next read: the row-parallel all-reduce);
    a weight split over a mesh dim that also splits the activation's
    batch is gathered (FSDP's all-gather). DTensor would often move
    the weight to the activation instead, and leave full-width
    partial sums behind.
  * **Einsums whose split dims are batch dims** (attention's batch and
    heads): run on the local shards. DTensor reaches an einsum as a
    bmm over flattened batch dims, and gathers every split dim after
    the first. Where two operands split different letters over one
    mesh dim and both have the larger's letter (a multi-query
    attention's P.V: the values split along head_dim over "model", the
    weights along the heads), the smaller moves its split to that
    letter. DTensor would flatten the batch and heads, split over two
    mesh dims, into one strided split, which sends every later op's
    layout search through its exhaustive redistribution planner:
    minutes a shape on the 3-D mesh.
  * **A lookup or a gather along a split dim** (the embedding's rows
    of a vocab-split table, the loss's gold logit over a vocab-split
    row): each rank looks up the indices that fall in its share, the
    others give 0, and the result is a partial sum (a table split over
    the batch's mesh dim too is gathered there first: FSDP). DTensor
    moves the table instead, and its masked gather fails on ``meta``
    shards.
  * **A log-sum-exp or an argmax along a split dim** (the loss over a
    vocab-split row, greedy decoding): a local max, its all-reduce, a
    local sum of exponentials and its all-reduce; or each rank's (max,
    index) pair, gathered. DTensor gathers the whole row first (and its
    argmax fails on a batch of one).
  * **A reshape that splits a split dim** into dims whose leading one
    does not divide the mesh dim (8 kv heads of a [B, S, 8 * 128]
    projection over 16 ranks), or that moves a split dim off the lead
    of the dims it merges or splits: the input is gathered over that
    mesh dim first. The partitioner re-tiles such a dim; DTensor
    refuses, or splits a later dim with a stride.

  * **An indexed write into a dim split over ranks** (a decode step's
    new K/V into a ring cache split along its slots): the indices and
    the values are gathered whole on every rank, as the partitioner
    gathers a scatter's updates, and each rank writes the entries that
    fall in its own shares. DTensor has no rule for it.
  * **Elementwise arithmetic between an activation and a small
    operand** (a norm's scale, split over "model" by the training
    layout): the small operand is laid out as the activation. DTensor
    would split the activation as the scale instead.

The rules sit at the torch-function level, over a scope (``with
SpmdRules()``), and not in DTensor's op table
(``torch.distributed.tensor.experimental.register_sharding``): five of
them run another local program than the op (a masked lookup or write,
local maxima and their all-reduce), which a sharding strategy cannot
state; a strategy is one list of placements for every mesh dim, from
which DTensor still picks by its own cost; and a registration holds for
the whole process, with no public way to take it back.

Every redistribution a rule makes is a DTensor collective that the
cost counter counts. An operand laid out anew for a product is kept for
the other products that read it (the q, k and v projections of one
normed activation share one gather, as the partitioner's common
subexpression does), for as long as the operand lives. Plain tensors
pass through untouched.
"""
from __future__ import annotations

import math
import weakref
from typing import Callable, List, Optional, Sequence

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.overrides import TorchFunctionMode
from torch.utils._pytree import tree_flatten

from repro_torch.models.layers import constrain

_MATMULS = {torch.Tensor.matmul, torch.matmul, torch.Tensor.__matmul__}
_RESHAPES = {torch.Tensor.reshape, torch.Tensor.view, torch.reshape}
_GATHERS = {torch.Tensor.gather, torch.gather}
_LOGSUMEXPS = {torch.logsumexp, torch.Tensor.logsumexp}
_ARGMAXES = {torch.argmax, torch.Tensor.argmax}
_ARITHMETIC = {torch.mul, torch.add, torch.sub, torch.div,
               torch.Tensor.mul, torch.Tensor.add, torch.Tensor.sub,
               torch.Tensor.div, torch.Tensor.__mul__, torch.Tensor.__rmul__,
               torch.Tensor.__add__, torch.Tensor.__radd__,
               torch.Tensor.__sub__, torch.Tensor.__rsub__,
               torch.Tensor.__truediv__, torch.Tensor.__rtruediv__}
_RULED = (_MATMULS | _RESHAPES | _GATHERS | _LOGSUMEXPS | _ARGMAXES
          | _ARITHMETIC | {torch.einsum, torch.Tensor.__getitem__,
                           torch.Tensor.__setitem__})
_LETTERS = "abcdefghij"    # batch letters ("k", "m", "n" kept)


def _global_stride(local: torch.Tensor, shape) -> tuple:
    """Strides of a tensor of the global ``shape`` whose dims lie in
    memory in the order of ``local``'s (a permuted einsum result stays
    permuted, so that a later reshape copies it, as it would the plain
    tensor). Computed: an allocation at a global shape would count as
    one."""
    order = sorted(range(local.dim()), key=lambda d: (-local.stride(d), d))
    stride, acc = [0] * local.dim(), 1
    for d in reversed(order):
        stride[d] = acc
        acc *= max(int(shape[d]), 1)
    return tuple(stride)


def wrap(local: torch.Tensor, mesh, placements, shape) -> DTensor:
    """``local`` as rank 0's shard of a DTensor of the global ``shape``."""
    return DTensor.from_local(local, mesh, placements, run_check=False,
                              shape=torch.Size(shape),
                              stride=_global_stride(local, shape))


def _as_dtensor(x, mesh) -> DTensor:
    """A plain operand as a DTensor whole on every rank."""
    if isinstance(x, DTensor):
        return x
    return DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def _shard_offset(x: DTensor, dim: int) -> int:
    """Where this rank's shard of ``dim`` starts (even shards)."""
    mesh, first, parts = x.device_mesh, 0, 1
    coord = mesh.get_coordinate()
    for i, p in enumerate(x.placements):
        if p.is_shard(dim):
            first = first * mesh.size(i) + coord[i]
            parts *= mesh.size(i)
    return first * (x.shape[dim] // parts)


def local_operand(x: DTensor, placements, partial_grad) -> torch.Tensor:
    """The local shard of ``x`` laid out by ``placements``. A dim whole
    on a mesh dim that ``placements`` split is cut locally (no
    collective); the gradient of such a cut, and on the mesh dims that
    ``partial_grad`` marks, is a partial sum over that mesh dim (what
    its copies' gradients are: their reduction is the backward pass's
    collective). Any other change of layout is a redistribution."""
    cut = [p.is_replicate() and t.is_shard()
           for p, t in zip(x.placements, placements)]
    x = constrain(x, [p if c else t
                      for p, t, c in zip(x.placements, placements, cut)])
    grad = [Partial() if c or g else p
            for p, c, g in zip(x.placements, cut, partial_grad)]
    local = x.to_local(grad_placements=grad)
    mesh = x.device_mesh
    coord = mesh.get_coordinate()
    for i, (t, c) in enumerate(zip(placements, cut)):
        if c:
            n = local.shape[t.dim] // mesh.size(i)
            local = local.narrow(t.dim, coord[i] * n, n)
    return local


def local_einsum(eq: str, operands: Sequence) -> Optional[DTensor]:
    """``torch.einsum(eq, *operands)`` run on the local shards: each mesh
    dim splits the letter that the largest operand splits there (or the
    next largest, where it is whole), each operand that has that letter
    is split along it there and the others are whole; a letter of the
    output stays split, a contracted one leaves a partial sum. None when
    an operand splits another letter over a mesh dim and lacks the
    chosen one, holds a partial sum, a split letter does not divide its
    mesh dims, or the equation has an ellipsis or a repeated letter."""
    eq = eq.replace(" ", "")
    if "..." in eq or "->" not in eq:
        return None
    lhs, out = eq.split("->")
    subs = lhs.split(",")
    dts = [x for x in operands if isinstance(x, DTensor)]
    if len(subs) != len(operands) or not dts \
            or any(len(set(s)) != len(s) for s in subs + [out]):
        return None
    mesh = dts[0].device_mesh
    letter_of: List[Optional[str]] = [None] * mesh.ndim
    sizes = {}
    for x, sub in zip(operands, subs):
        sizes.update(zip(sub, x.shape))
    # the largest operand's splits first: an operand that splits another
    # letter over the same mesh dim moves its split to the larger's letter
    for x, sub in sorted(zip(operands, subs), key=lambda xs: -xs[0].numel()):
        if not isinstance(x, DTensor):
            continue
        if x.device_mesh != mesh:
            return None
        for i, p in enumerate(x.placements):
            if p.is_partial():
                return None
            if not p.is_shard():
                continue
            if letter_of[i] is None:
                letter_of[i] = sub[p.dim]
            elif letter_of[i] not in sub:
                return None
    if all(letter is None for letter in letter_of):
        return None
    for letter in set(letter_of) - {None}:
        n = math.prod(mesh.size(i) for i, c in enumerate(letter_of)
                      if c == letter)
        if sizes[letter] % n:
            return None
    locals_ = []
    for x, sub in zip(operands, subs):
        pl = [Shard(sub.index(c)) if c is not None and c in sub
              else Replicate() for c in letter_of]
        # a letter this operand lacks splits the work over its copies:
        # their gradients are partial sums
        partial = [c is not None and c not in sub for c in letter_of]
        locals_.append(local_operand(_as_dtensor(x, mesh), pl, partial))
    local = torch.einsum(eq, *locals_)
    out_pl = [Replicate() if c is None else
              Shard(out.index(c)) if c in out else Partial()
              for c in letter_of]
    return wrap(local, mesh, out_pl, [sizes[c] for c in out])


def weight_product(x, w, relayout: Callable = constrain
                   ) -> Optional[DTensor]:
    """``x @ w`` under the product rule of the module docstring, through
    :func:`local_einsum` (``relayout(t, placements)`` lays an operand
    out). ``w`` is [K, N], or [*B, K, N] with ``x`` [*B, M, K] (the
    experts' weights, the MoE's dispatch and combine): a dim of B split
    in ``w`` is split in ``x`` too. A partial-sum ``x`` is reduced first
    (scattered along K where ``w`` splits K). None for a partial ``w``
    or batch dims that broadcast."""
    if not isinstance(w, DTensor) or w.dim() < 2 or x.dim() < 2:
        return None
    nb = w.dim() - 2
    if nb and (x.dim() != w.dim() or x.shape[:nb] != w.shape[:nb]):
        return None
    mesh = w.device_mesh
    x = _as_dtensor(x, mesh)
    if any(p.is_partial() for p in w.placements):
        return None
    k, wk, wn = x.dim() - 1, nb, nb + 1
    x_pl, w_pl = list(x.placements), list(w.placements)
    for i, (xp, wp) in enumerate(zip(x.placements, w.placements)):
        if xp.is_partial():     # reduced: scattered along K for a row split
            x_pl[i] = xp = Shard(k) if wp.is_shard(wk) else Replicate()
        x_k = xp.is_shard(k)
        x_other = xp.is_shard() and not x_k
        if wp.is_shard() and wp.dim < nb:     # a batch dim both share
            x_pl[i] = Shard(wp.dim)
        elif wp.is_shard(wn):                 # column-parallel
            if x_k:
                x_pl[i] = Replicate()         # gather the activation
            elif x_other:
                w_pl[i] = Replicate()         # one split per mesh dim
        elif wp.is_shard(wk):                 # row-parallel, or FSDP on K
            if x_other and not xp.dim < nb:
                w_pl[i] = Replicate()         # FSDP: gather the weight
            elif not x_other:
                x_pl[i] = Shard(k)            # free: a partial sum out
        elif x_k:
            x_pl[i] = Replicate()
    shared, rest = _LETTERS[:nb], _LETTERS[nb:k]
    return local_einsum(f"{shared}{rest}k,{shared}kn->{shared}{rest}n",
                        [relayout(x, x_pl), relayout(w, w_pl)])


def sharded_lookup(table, index, relayout: Callable = constrain
                   ) -> Optional[DTensor]:
    """``table[index]`` (rows of a DTensor ``table`` split along dim 0,
    by an integer ``index``) as a masked local lookup summed over the
    ranks that split the rows. None for any other indexing."""
    if not isinstance(index, torch.Tensor) or index.is_floating_point() \
            or index.dtype == torch.bool or not _split_along(table, 0):
        return None
    mesh = table.device_mesh
    index = _as_dtensor(index, mesh)
    if any(p.is_partial() for p in index.placements):
        return None
    t_pl = list(table.placements)
    out_pl = []
    for i, (tp, ip) in enumerate(zip(table.placements, index.placements)):
        if tp.is_shard(0):
            if ip.is_shard():
                return None
            out_pl.append(Partial())
        elif tp.is_shard():
            if ip.is_shard():
                t_pl[i] = Replicate()       # FSDP: gather the table
                out_pl.append(ip)
            else:
                out_pl.append(Shard(index.dim() + tp.dim - 1))
        else:
            out_pl.append(ip)
    table = relayout(table, t_pl)
    local = table.to_local(grad_placements=[
        Partial() if ip.is_shard() and tp.is_replicate() else tp
        for tp, ip in zip(table.placements, index.placements)])
    rel = index.to_local() - _shard_offset(table, 0)
    inside = (rel >= 0) & (rel < local.shape[0])
    rows = local[rel.clamp(0, local.shape[0] - 1)]
    rows = torch.where(inside.reshape(*inside.shape,
                                      *[1] * (local.dim() - 1)),
                       rows, torch.zeros((), dtype=rows.dtype,
                                         device=rows.device))
    return wrap(rows, mesh, out_pl,
                 [*index.shape, *table.shape[1:]])


def sharded_gather(x, dim: int, index, **kwargs) -> Optional[DTensor]:
    """``torch.gather(x, dim, index)`` for a DTensor ``x`` split along
    ``dim``: a masked gather of the rank's own share, summed over the
    ranks (a partial sum). ``index`` is laid out as ``x`` on the other
    dims. None when ``dim`` is whole."""
    if kwargs or not _split_along(x, dim):
        return None
    x, dim = _summed(x), dim % x.dim()
    mesh = x.device_mesh
    idx_pl = [Replicate() if p.is_shard(dim) else p for p in x.placements]
    idx = constrain(_as_dtensor(index, mesh), idx_pl).to_local()
    local = x.to_local()
    n = local.shape[dim]
    rel = idx - _shard_offset(x, dim)
    inside = (rel >= 0) & (rel < n)
    got = local.gather(dim, rel.clamp(0, n - 1))
    got = torch.where(inside, got, torch.zeros((), dtype=got.dtype,
                                                device=got.device))
    out_pl = [Partial() if p.is_shard(dim) else p for p in x.placements]
    return wrap(got, mesh, out_pl, index.shape)


def sharded_index_put(x, key, value) -> bool:
    """``x[key] = value`` in place, for a DTensor ``x`` split along a dim
    that ``key`` (a tuple of integer tensors, one for each leading dim of
    ``x``) indexes: the indices and ``value`` are gathered whole on each
    rank (``value`` stays split along the trailing dims that ``x``
    splits), and each rank writes the entries that fall in its own
    shares. An entry outside them writes what the rank's first entry
    inside writes, or, where none is inside, what is there already: the
    result is exact wherever the entries write distinct positions, as
    for the plain write. False for any other write."""
    if not (isinstance(x, DTensor) and isinstance(key, tuple)
            and 0 < len(key) <= x.dim()
            and all(isinstance(i, torch.Tensor) and not i.is_floating_point()
                    and i.dtype != torch.bool for i in key)
            and any(_split_along(x, d) for d in range(len(key)))
            and not any(p.is_partial() for p in x.placements)):
        return False
    mesh, n = x.device_mesh, len(key)
    whole = [Replicate()] * mesh.ndim
    idx = torch.broadcast_tensors(*[constrain(_as_dtensor(i, mesh),
                                              whole).to_local()
                                    for i in key])
    value = _as_dtensor(torch.as_tensor(value), mesh)
    shift = value.dim() - x.dim()
    value = constrain(value, [
        Shard(p.dim + shift) if p.is_shard() and p.dim >= n
        and p.dim + shift >= 0 and value.shape[p.dim + shift] > 1
        else Replicate() for p in x.placements]).to_local()
    local = x.to_local()
    rel = [i - _shard_offset(x, d) for d, i in enumerate(idx)]
    inside = torch.ones_like(rel[0], dtype=torch.bool)
    for d, r in enumerate(rel):
        inside = inside & (r >= 0) & (r < local.shape[d])
    first = inside.flatten().to(torch.uint8).argmax().reshape(1)
    at = tuple(torch.where(inside, r, r.flatten().index_select(0, first))
               .clamp(0, local.shape[d] - 1) for d, r in enumerate(rel))
    new = torch.broadcast_to(value.to(local.dtype),
                             (*inside.shape, *local.shape[n:]))
    mask = inside.reshape(*inside.shape, *[1] * (local.dim() - n))
    vals = torch.where(mask, new, new.reshape(-1, *local.shape[n:])
                       .index_select(0, first))
    local[at] = torch.where(inside.any(), vals, local[at])
    return True


def _split_along(x, dim) -> bool:
    """Whether DTensor ``x`` is split along ``dim``."""
    return (isinstance(x, DTensor) and isinstance(dim, int)
            and any(p.is_shard(dim % x.dim()) for p in x.placements))


def _summed(x: DTensor) -> DTensor:
    """``x`` with its partial sums reduced (whole on those mesh dims)."""
    return constrain(x, [Replicate() if p.is_partial() else p
                         for p in x.placements])


def _reduced_placements(x: DTensor, dim: int, keepdim: bool) -> list:
    """Placements of a reduction of ``x`` over ``dim``: whole where ``x``
    was split along it, later dims renumbered without ``keepdim``."""
    out = []
    for p in x.placements:
        if p.is_shard(dim):
            p = Replicate()
        elif p.is_shard() and p.dim > dim and not keepdim:
            p = Shard(p.dim - 1)
        out.append(p)
    return out


def sharded_logsumexp(x, dim: int, keepdim: bool = False
                      ) -> Optional[DTensor]:
    """``torch.logsumexp(x, dim)`` for a DTensor ``x`` split along
    ``dim``, from local maxima and sums and two all-reduces of their
    [..., 1] results. None when ``dim`` is whole."""
    if not _split_along(x, dim):
        return None
    x, dim = _summed(x), dim % x.dim()
    mesh = x.device_mesh
    shape = list(x.shape)
    shape[dim] = 1

    def reduced(local, op):
        partial = [Partial(op) if p.is_shard(dim) else p
                   for p in x.placements]
        whole = [Replicate() if p.is_shard(dim) else p
                 for p in x.placements]
        return wrap(local, mesh, partial, shape).redistribute(
            mesh, whole).to_local()

    local = x.to_local()
    top = reduced(local.amax(dim, keepdim=True), "max")
    total = reduced((local - top).exp().sum(dim, keepdim=True), "sum")
    out = total.log() + top
    if not keepdim:
        out = out.squeeze(dim)
        del shape[dim]
    return wrap(out, mesh, _reduced_placements(x, dim, keepdim), shape)


def sharded_argmax(x, dim: int, keepdim: bool = False
                   ) -> Optional[DTensor]:
    """``torch.argmax(x, dim)`` for a DTensor ``x`` split along ``dim``:
    each rank's (max, global index) pair is gathered over the ranks that
    split ``dim``, and the first largest wins (the lowest index, as
    ``argmax`` breaks ties). None when ``dim`` is whole."""
    if not _split_along(x, dim):
        return None
    x, dim = _summed(x), dim % x.dim()
    mesh = x.device_mesh
    parts = math.prod(mesh.size(i) for i, p in enumerate(x.placements)
                      if p.is_shard(dim))
    shape = list(x.shape)
    shape[dim] = parts
    whole = [Replicate() if p.is_shard(dim) else p for p in x.placements]
    vals, idx = x.to_local().max(dim, keepdim=True)
    vals, idx = (wrap(t, mesh, x.placements, shape).redistribute(
        mesh, whole).to_local() for t in (vals, idx + _shard_offset(x, dim)))
    out = idx.gather(dim, vals.argmax(dim, keepdim=True))
    shape[dim] = 1
    if not keepdim:
        out = out.squeeze(dim)
        del shape[dim]
    return wrap(out, mesh, _reduced_placements(x, dim, keepdim), shape)


def follow_the_larger(a, b):
    """Operands ``a`` and ``b`` of a broadcasting elementwise op, the one
    with fewer elements laid out as the other: split where the other is
    split along a dim it shares (aligned from the right), else whole."""
    if not (isinstance(a, DTensor) and isinstance(b, DTensor)) \
            or a.numel() == b.numel():
        return a, b
    big, small = (a, b) if a.numel() > b.numel() else (b, a)
    if any(p.is_partial() for p in big.placements):
        return a, b
    shift = big.dim() - small.dim()
    placements = []
    for p in big.placements:
        d = p.dim - shift if p.is_shard() else -1
        placements.append(Shard(d) if d >= 0 and small.shape[d] > 1
                          else Replicate())
    small = constrain(small, placements)
    return (big, small) if a is big else (small, big)


def split_for_reshape(x: DTensor, shape, everything: bool = False
                      ) -> DTensor:
    """``x`` laid out for a reshape to ``shape``: gathered over each mesh
    dim that splits a dim the reshape changes (those between the leading
    and trailing dims it keeps), unless that dim leads the changed ones
    and the reshape's first changed dim divides the split; with
    ``everything``, over each mesh dim that splits a changed dim."""
    new = [int(n) for n in shape]
    if -1 in new:
        known = math.prod(n for n in new if n != -1)
        new[new.index(-1)] = x.numel() // known
    old = list(x.shape)
    lead = 0
    while lead < min(len(old), len(new)) and old[lead] == new[lead]:
        lead += 1
    trail = 0
    while trail < min(len(old), len(new)) - lead \
            and old[-1 - trail] == new[-1 - trail]:
        trail += 1
    changed = range(lead, len(old) - trail)
    mesh = x.device_mesh
    parts = math.prod(mesh.size(i) for i, p in enumerate(x.placements)
                      if p.is_shard(lead))
    keeps_lead = (not everything and lead < len(new) - trail
                  and new[lead] % parts == 0)
    return constrain(x, [
        Replicate() if p.is_shard() and p.dim in changed
        and not (p.dim == lead and keeps_lead) else p
        for p in x.placements])


class SpmdRules(TorchFunctionMode):
    """Applies the rules of the module docstring to the ops run under
    it; any other op, and any op on plain tensors, runs as it is.

    A mode is off while it handles a call, and so would be for all of a
    ``torch.autograd.grad`` call: its backward pass and the forwards that
    checkpointed layers recompute in it. So a gradient call runs the
    autograd engine itself with the mode back on."""

    def __init__(self):
        super().__init__()
        self._relaid: dict = {}

    def _relayout(self, x, placements):
        """``constrain(x, placements)``, the same result for the same
        operand and placements while the operand lives."""
        if not isinstance(x, DTensor) \
                or tuple(x.placements) == tuple(placements):
            return x
        key = (id(x), tuple(placements))
        hit = self._relaid.get(key)
        if hit is not None and hit[0]() is x:
            return hit[1]
        out = constrain(x, placements)
        self._relaid[key] = (weakref.ref(
            x, lambda _, key=key: self._relaid.pop(key, None)), out)
        return out

    def _grad(self, outputs, inputs, grad_outputs=None, retain_graph=None,
              create_graph=False, allow_unused=None, only_inputs=True,
              is_grads_batched=False, materialize_grads=False):
        if is_grads_batched or materialize_grads:
            raise NotImplementedError("torch.autograd.grad with batched or "
                                      "materialised gradients")
        from torch.autograd.variable import Variable
        outs = (outputs,) if isinstance(outputs, torch.Tensor) \
            else tuple(outputs)
        ins = (inputs,) if isinstance(inputs, torch.Tensor) else tuple(inputs)
        if grad_outputs is None:
            grad_outputs = tuple(torch.ones_like(o) for o in outs)
        elif isinstance(grad_outputs, torch.Tensor):
            grad_outputs = (grad_outputs,)
        with self:
            return Variable._execution_engine.run_backward(
                outs, tuple(grad_outputs),
                create_graph if retain_graph is None else retain_graph,
                create_graph, ins, bool(allow_unused), False)

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func is torch.autograd.grad:
            return self._grad(*args, **kwargs)
        if func not in _RULED or not any(
                isinstance(x, DTensor)
                for x in tree_flatten((args, kwargs))[0]):
            return func(*args, **kwargs)
        out = None
        if func in _MATMULS and len(args) == 2 and not kwargs:
            out = weight_product(*args, relayout=self._relayout)
        elif func is torch.einsum and isinstance(args[0], str):
            ops = args[1] if len(args) == 2 and isinstance(
                args[1], (list, tuple)) else args[1:]
            out = local_einsum(args[0], list(ops))
        elif func in _GATHERS:
            out = sharded_gather(*args, **kwargs)
        elif func in _LOGSUMEXPS:
            out = sharded_logsumexp(*args, **kwargs)
        elif func in _ARGMAXES:
            out = sharded_argmax(*args, **kwargs)
        elif func is torch.Tensor.__setitem__ and len(args) == 3:
            if sharded_index_put(*args):
                return None
        elif func is torch.Tensor.__getitem__ and len(args) == 2:
            out = sharded_lookup(*args, relayout=self._relayout)
        elif func in _ARITHMETIC and len(args) == 2:
            return func(*follow_the_larger(*args), **kwargs)
        elif func in _RESHAPES and isinstance(args[0], DTensor):
            shape = args[1] if len(args) == 2 and not isinstance(
                args[1], int) else args[1:]
            try:
                return func(split_for_reshape(args[0], shape), *args[1:],
                            **kwargs)
            except RuntimeError:
                return func(split_for_reshape(args[0], shape, True),
                            *args[1:], **kwargs)
        return func(*args, **kwargs) if out is None else out

