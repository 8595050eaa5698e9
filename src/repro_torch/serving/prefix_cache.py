"""Cross-request prefix cache: a radix tree over block-aligned token
prefixes, parking completed prompts' KV blocks for zero-recompute reuse.

The paper's bottleneck is KV pressure: traces are pruned when the paged
pool saturates. Every byte of KV reused ACROSS requests (system prompts,
few-shot templates, multi-turn conversation prefixes) is pruning
pressure avoided, so the engine keeps a trie keyed by ``block_size``
token chunks on top of the refcounted ``BlockManager``:

  * On request arrival the engine walks the trie for the longest cached
    block-aligned strict prefix of the prompt (``match``), forks the
    matched blocks via the existing COW path (refcount++, zero device
    work) and chunk-prefills only the suffix.
  * On request completion the prompt's FULL blocks are inserted into the
    trie instead of freed (``insert``): the cache takes over the
    holder's references, so the blocks stay live at refcount >= 1 and
    pristine (the holder never writes; traces always COW before their
    first private write).
  * Under memory pressure the engine reclaims least-recently-used
    cache-only blocks (``evict``) BEFORE consulting the pruning policy:
    evict-before-prune, because a cached block is a reuse opportunity
    while a live trace is paid-for compute.

Partial tail blocks are never cached: ``match`` stops at
``(len(prompt) - 1) // block_size`` chunks (at least one prompt token is
always left to prefill — its logits seed the first sampled token) and
``insert`` parks only ``len(prompt) // block_size`` full blocks. A tail
block holds fewer than ``block_size`` valid KV rows and is written by
the request's own prefill, so sharing it would serve stale rows.

The cache never touches device memory; like the allocator it only moves
ownership. A cached block's KV bytes were written by a completed prefill
of the identical token prefix, which is why a hit is bit-identical to
recomputing the prefix (pinned in tests/test_prefix_cache.py).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

from repro_torch.serving.kv_manager import BlockManager


class _Node:
    """One trie edge/node: ``key`` is the block's token chunk, ``block``
    the physical block id (the cache holds exactly one reference)."""

    __slots__ = ("key", "block", "parent", "children", "last_used")

    def __init__(self, key: Optional[tuple], block: Optional[int],
                 parent: Optional["_Node"]):
        self.key = key
        self.block = block
        self.parent = parent
        self.children: Dict[tuple, _Node] = {}
        self.last_used = 0


@dataclasses.dataclass
class CacheStats:
    """Cumulative hit/occupancy counters (engine lifetime)."""

    lookups: int = 0
    hits: int = 0            # lookups matching >= 1 block
    misses: int = 0
    hit_tokens: int = 0      # prompt tokens served straight from cache
    inserted_blocks: int = 0
    evicted_blocks: int = 0


class PrefixCache:
    """Radix-tree index of parked prompt KV blocks over a BlockManager.

    LRU bookkeeping uses a deterministic monotonic clock (not wall
    time), so eviction order — and therefore scheduling — is a pure
    function of the operation history.
    """

    def __init__(self, mgr: BlockManager):
        self.mgr = mgr
        self.block_size = mgr.block_size
        self.root = _Node(None, None, None)
        self.stats = CacheStats()
        self._clock = 0
        self._num_blocks = 0

    # ------------------------------------------------------------------
    # occupancy
    # ------------------------------------------------------------------
    @property
    def cached_blocks(self) -> int:
        """Blocks currently parked in the trie."""
        return self._num_blocks

    @property
    def evictable_blocks(self) -> int:
        """Parked blocks only the cache references (refcount 1): the
        amount ``evict`` could return to the free list right now."""
        return sum(1 for n in self._nodes()
                   if self.mgr.ref_count(n.block) == 1)

    def blocks(self) -> Iterator[int]:
        """Physical block ids currently parked in the trie."""
        for node in self._nodes():
            yield node.block

    def _nodes(self) -> Iterator[_Node]:
        stack = list(self.root.children.values())
        while stack:
            node = stack.pop()
            stack.extend(node.children.values())
            yield node

    def _chunks(self, tokens: Sequence[int], n: int) -> List[tuple]:
        bs = self.block_size
        return [tuple(tokens[i * bs:(i + 1) * bs]) for i in range(n)]

    # ------------------------------------------------------------------
    # lookup / insert
    # ------------------------------------------------------------------
    def match(self, tokens: Sequence[int]) -> Tuple[List[int], int]:
        """Longest cached block-aligned strict prefix of ``tokens``.

        Returns ``(blocks, n_tokens)``. The match is capped at
        ``(len(tokens) - 1) // block_size`` chunks so at least one
        prompt token always remains to prefill (its logits seed the
        first sampled token). The caller must ``mgr.fork`` the returned
        blocks before using them; until then they are only pinned by the
        cache's own reference.
        """
        limit = max(len(tokens) - 1, 0) // self.block_size
        self._clock += 1
        node, blocks = self.root, []
        for key in self._chunks(tokens, limit):
            child = node.children.get(key)
            if child is None:
                break
            child.last_used = self._clock  # stamp the whole matched path
            blocks.append(child.block)
            node = child
        self.stats.lookups += 1
        if blocks:
            self.stats.hits += 1
            self.stats.hit_tokens += len(blocks) * self.block_size
        else:
            self.stats.misses += 1
        return blocks, len(blocks) * self.block_size

    def insert(self, tokens: Sequence[int], blocks: Sequence[int]) -> int:
        """Park a completed prompt's full-block KV in the trie.

        ``blocks`` are the holder's references covering the prompt's
        full blocks in order (the partial tail block must NOT be
        passed). Ownership transfer per chunk: a chunk with no trie node
        yet moves the caller's reference into the cache; a chunk already
        cached (same or different physical block) drops the caller's
        duplicate reference via ``mgr.free``. Either way the caller owns
        nothing afterwards. Returns the number of newly parked blocks.
        """
        n = min(len(tokens) // self.block_size, len(blocks))
        self._clock += 1
        node, new = self.root, 0
        for i, key in enumerate(self._chunks(tokens, n)):
            child = node.children.get(key)
            if child is None:
                child = _Node(key, blocks[i], node)
                node.children[key] = child
                self._num_blocks += 1
                new += 1
            else:
                # duplicate coverage of this chunk: the cache keeps its
                # existing block, the caller's reference is dropped
                self.mgr.free([blocks[i]])
            child.last_used = self._clock
            node = child
        self.stats.inserted_blocks += new
        return new

    # ------------------------------------------------------------------
    # eviction
    # ------------------------------------------------------------------
    def evict(self, n_blocks: int) -> int:
        """Return up to ``n_blocks`` LRU cache-only blocks to the free
        list (leaf-first, so a cold subtree unwinds bottom-up). Blocks
        some request still references (refcount > 1) are pinned and
        skipped. Returns the number of blocks actually freed."""
        freed = 0
        while freed < n_blocks:
            victim = None
            for node in self._nodes():
                if node.children or self.mgr.ref_count(node.block) != 1:
                    continue
                if victim is None or node.last_used < victim.last_used:
                    victim = node
            if victim is None:
                break
            self.mgr.free([victim.block])
            del victim.parent.children[victim.key]
            self._num_blocks -= 1
            freed += 1
        self.stats.evicted_blocks += freed
        return freed

    def clear(self) -> int:
        """Drop every parked block (benchmark warmup isolation). Blocks
        still referenced elsewhere survive with the other references;
        cache-only blocks return to the free list."""
        dropped = 0
        for node in list(self._nodes()):
            self.mgr.free([node.block])
            dropped += 1
        self.root.children.clear()
        self._num_blocks = 0
        return dropped

    # ------------------------------------------------------------------
    def check_integrity(self) -> None:
        """Trie-side invariants, in the spirit of
        ``BlockManager.check_invariants``."""
        seen = 0
        block_ids = set()
        for node in self._nodes():
            assert node.key is not None and len(node.key) == self.block_size
            assert self.mgr.ref_count(node.block) >= 1, \
                f"cached block {node.block} is dead"
            assert node.parent.children.get(node.key) is node
            assert node.block not in block_ids, \
                f"block {node.block} parked under two trie nodes"
            block_ids.add(node.block)
            seen += 1
        assert seen == self._num_blocks, \
            f"cached_blocks={self._num_blocks} but trie holds {seen}"
