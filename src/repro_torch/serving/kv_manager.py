"""Paged KV block manager (vLLM-style, host-side allocator).

The device-side pool is a statically allocated JAX array sized to the HBM
budget; this manager hands out block ids. "GPU memory full" in the paper
== "free list empty at schedule time" here (see DESIGN.md §3).

Block 0 is reserved as a scratch block: dead decode slots point their
block tables at it so a fixed-shape batched decode step can run without
corrupting live sequences.

Prefix sharing (vLLM-style copy-on-write): every live block carries a
reference count. ``fork(blocks)`` hands the same physical blocks to a
second logical sequence by incrementing the counts; ``free`` decrements
and only returns a block to the free list when its count reaches zero.
A writer must hold a block exclusively — the engine checks
``is_shared`` before the next token's KV write and, if the block is
shared, allocates a fresh block, device-copies the contents, and drops
its reference on the original (the COW step). The allocator itself
never touches device memory; it only tracks ownership.

Chunk-granular reservation (continuous batching / chunked prefill): an
in-flight prompt prefill draws its blocks chunk by chunk through a
``Reservation`` instead of allocating the whole prompt up front. Blocks
already taken hold completed chunks' KV; ``take`` extends the holding as
later chunks are computed; ``abort`` returns everything to the pool if
the prefill is cancelled under memory pressure; ``commit`` transfers
ownership of the full set to the caller (the shared-prefix holder).

Cross-request prefix caching (``serving/prefix_cache.py``) layers on the
same refcounts: a completed request's full prompt blocks are PARKED —
the cache keeps one reference per block instead of freeing it — so a
later request with the same token prefix forks them (refcount++) with
zero recompute. Parked blocks at refcount 1 are reclaimed LRU-first
under memory pressure, before any live trace is pruned or preempted.
The allocator needs no new machinery for this; the cache is just
another reference holder.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Set


@dataclasses.dataclass
class BlockManager:
    num_blocks: int
    block_size: int
    # HBM bytes one block occupies on device (pool storage across all
    # attention layers, plus per-page scales for quantized pools). 0 =
    # unknown; the engine passes kv_quant.pool_block_bytes so pressure
    # snapshots can report real bytes, not just block counts.
    bytes_per_block: int = 0

    def __post_init__(self):
        assert self.num_blocks >= 2
        self._free: List[int] = list(range(1, self.num_blocks))  # 0=scratch
        self._free_set = set(self._free)  # O(1) membership / double-free check
        self._refcounts: Dict[int, int] = {}  # block id -> refs (live only)
        self._open_reservations: Set["Reservation"] = set()  # not yet closed
        # fault injection: when set, a True return vetoes the allocation
        # (the allocator reports "full" without touching state)
        self.fault_hook: Optional[Callable[[int], bool]] = None

    @property
    def scratch_block(self) -> int:
        return 0

    @property
    def free_blocks(self) -> int:
        return len(self._free)

    @property
    def used_blocks(self) -> int:
        return (self.num_blocks - 1) - len(self._free)

    @property
    def utilization(self) -> float:
        return self.used_blocks / (self.num_blocks - 1)

    @property
    def free_bytes(self) -> int:
        return self.free_blocks * self.bytes_per_block

    @property
    def used_bytes(self) -> int:
        return self.used_blocks * self.bytes_per_block

    def blocks_for_tokens(self, n_tokens: int) -> int:
        return -(-n_tokens // self.block_size)

    def can_allocate(self, n_blocks: int) -> bool:
        if self.fault_hook is not None and self.fault_hook(n_blocks):
            return False
        return len(self._free) >= n_blocks

    def allocate(self, n_blocks: int) -> Optional[List[int]]:
        if not self.can_allocate(n_blocks):
            return None
        out = self._free[:n_blocks]
        del self._free[:n_blocks]
        for b in out:
            self._free_set.discard(b)
            self._refcounts[b] = 1
        return out

    def fork(self, blocks: List[int]) -> List[int]:
        """Share ``blocks`` with one more logical sequence (refcount += 1).

        Returns a fresh list of the same physical block ids; the caller
        owns one reference per id and releases it through ``free``.
        """
        for b in blocks:
            assert self._refcounts.get(b, 0) > 0, f"fork of dead block {b}"
            self._refcounts[b] += 1
        return list(blocks)

    def ref_count(self, block: int) -> int:
        return self._refcounts.get(block, 0)

    def is_shared(self, block: int) -> bool:
        return self._refcounts.get(block, 0) > 1

    def free(self, blocks: List[int]) -> None:
        """Drop one reference per block; release at refcount zero."""
        for b in blocks:
            assert b != 0 and b not in self._free_set, f"double free of {b}"
            refs = self._refcounts.get(b, 0)
            assert refs > 0, f"free of unallocated block {b}"
            if refs > 1:
                self._refcounts[b] = refs - 1
            else:
                del self._refcounts[b]
                self._free.append(b)
                self._free_set.add(b)

    def reserve(self, total_blocks: int) -> "Reservation":
        """Open a chunk-granular reservation for ``total_blocks`` blocks.

        Nothing is allocated yet; the caller draws blocks incrementally
        with ``Reservation.take`` as prefill chunks complete.
        """
        return Reservation(self, total_blocks)

    def check_invariants(self) -> None:
        assert len(set(self._free)) == len(self._free)
        assert self._free_set == set(self._free)
        assert all(1 <= b < self.num_blocks for b in self._free)
        assert all(r > 0 for r in self._refcounts.values())
        # every non-scratch block is exactly one of {free, live}
        assert not (self._free_set & self._refcounts.keys())
        assert len(self._free) + len(self._refcounts) == self.num_blocks - 1

    @property
    def open_reservations(self) -> int:
        return len(self._open_reservations)

    def check_integrity(self, expect_open_reservations: int = 0) -> None:
        """Post-fault invariant audit: refcount conservation plus no
        orphaned (never-closed) reservations. Cheap enough to run after
        every fault/cancel path."""
        self.check_invariants()
        assert len(self._open_reservations) == expect_open_reservations, \
            (f"{len(self._open_reservations)} reservation(s) left open "
             f"(expected {expect_open_reservations}) — an exception path "
             f"skipped commit/abort")


class Reservation:
    """Incremental block holding for an in-flight (chunked) prefill.

    Lifecycle: ``take`` zero or more times (each call either allocates
    the requested blocks or, when the free list is short, takes nothing
    and returns None so the caller can apply memory pressure), then
    exactly one of ``commit`` (ownership moves to the caller) or
    ``abort`` (blocks return to the pool). A reservation never holds
    more than ``total_blocks``.
    """

    def __init__(self, mgr: BlockManager, total_blocks: int):
        assert total_blocks >= 0
        self.mgr = mgr
        self.total_blocks = total_blocks
        self.taken: List[int] = []
        self._closed = False
        mgr._open_reservations.add(self)

    @property
    def num_taken(self) -> int:
        return len(self.taken)

    @property
    def remaining(self) -> int:
        return self.total_blocks - len(self.taken)

    def take(self, n_blocks: int) -> Optional[List[int]]:
        """Draw ``n_blocks`` more blocks; all-or-nothing per call."""
        assert not self._closed, "take on a closed reservation"
        assert n_blocks <= self.remaining, "reservation overdraw"
        if n_blocks == 0:
            return []
        got = self.mgr.allocate(n_blocks)
        if got is None:
            return None
        self.taken.extend(got)
        return got

    def commit(self) -> List[int]:
        """Close the reservation; the caller now owns the taken blocks."""
        assert not self._closed
        self._closed = True
        self.mgr._open_reservations.discard(self)
        out = self.taken
        self.taken = []
        return out

    def abort(self) -> None:
        """Cancel: return every taken block to the pool."""
        assert not self._closed
        self._closed = True
        self.mgr._open_reservations.discard(self)
        if self.taken:
            self.mgr.free(self.taken)
            self.taken = []
