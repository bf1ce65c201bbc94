"""Radix prefix KV cache: share prompt pages across requests.

Chat fleets serve many tenants whose requests open with the same
system prompt; recomputing that prefix's KV for every request burns
prefill FLOPs and steals decode steps.  This module keeps a *radix
tree over full KV pages*: each node is one page of ``block_size``
tokens keyed by the exact token chunk it holds.  Admission walks the
tree with the new prompt's tokens — every matched node is a page of
KV the new sequence can map read-only into its block table
(``PagedKVCache.allocate_with_prefix``) and skip at prefill time.

Sharing is safe because pages are refcounted and strictly read-only
once published: a sequence that must write *into* a shared page (the
common whole-prompt-cached case, where the last prompt token is
recomputed to produce first-token logits) takes a private copy first
(copy-on-extend via ``PagedKVCache.copy_on_write``).

The cache holds its own reference on every published page, so a page
stays resident after its donor sequence finishes.  Under pool
pressure the engine calls ``evict`` which drops least-recently-used
*unreferenced* leaf branches (pages no live sequence maps) until
enough pages are free — hot shared prefixes survive, cold one-off
prompts are recycled first.

Tree operations are O(prompt_len / block_size) dict hops; the tree is
tiny next to the pages it indexes.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Sequence, Tuple

from .kv_cache import PagedKVCache


class _Node:
    __slots__ = ("key", "page", "children", "parent", "last_use")

    def __init__(self, key, page, parent):
        self.key = key                     # tuple of block_size tokens
        self.page = page                   # physical page index
        self.children: Dict[tuple, "_Node"] = {}
        self.parent: Optional["_Node"] = parent
        self.last_use = 0


class RadixPrefixCache:
    """Token-prefix radix tree over ``PagedKVCache`` pages."""

    def __init__(self, cache: PagedKVCache):
        self.cache = cache
        self.block_size = cache.block_size
        self._root = _Node(None, -1, None)
        self._clock = 0                    # monotonic LRU counter
        self._nodes = 0
        self._lock = threading.Lock()
        # telemetry (surfaced through engine.metrics())
        self._lookups = 0
        self._hits = 0
        self._hit_tokens = 0
        self._inserted_pages = 0
        self._evicted_pages = 0

    # ---- admission-time lookup ----

    def lookup(self, tokens: Sequence[int]) -> Tuple[int, List[int]]:
        """Longest cached prefix of ``tokens`` in whole pages.

        Returns ``(matched_tokens, pages)`` and bumps the matched
        path's LRU clock.  Only full pages match — a partial final
        chunk is never shared because its page would still be written.
        """
        bs = self.block_size
        with self._lock:
            self._lookups += 1
            node = self._root
            pages: List[int] = []
            self._clock += 1
            i = 0
            while i + bs <= len(tokens):
                key = tuple(tokens[i:i + bs])
                child = node.children.get(key)
                if child is None:
                    break
                child.last_use = self._clock
                pages.append(child.page)
                node = child
                i += bs
            if pages:
                self._hits += 1
                self._hit_tokens += i
            return i, pages

    # ---- publication ----

    def insert(self, tokens: Sequence[int], block_table: List[int]) -> int:
        """Donate a finished prefill's full prompt pages to the tree.

        ``block_table[i]`` must hold tokens ``[i*bs, (i+1)*bs)``.  Only
        pages completely covered by ``tokens`` are published; chunks
        already present are skipped (first writer wins — both copies
        hold identical KV, the duplicate page simply stays private to
        its sequence).  Returns the number of newly published pages.
        """
        bs = self.block_size
        added = 0
        with self._lock:
            self._clock += 1
            node = self._root
            for i in range(len(tokens) // bs):
                key = tuple(tokens[i * bs:(i + 1) * bs])
                child = node.children.get(key)
                if child is None:
                    page = block_table[i]
                    try:
                        # the cache's own reference keeps the page
                        # resident after the donor sequence finishes
                        self.cache.incref([page])
                    except ValueError:
                        break
                    child = _Node(key, page, node)
                    node.children[key] = child
                    self._nodes += 1
                    self._inserted_pages += 1
                    added += 1
                child.last_use = self._clock
                node = child
        return added

    # ---- eviction ----

    def evict(self, pages_needed: int,
              pinned: Optional[set] = None) -> int:
        """Drop LRU unreferenced leaf branches until ``pages_needed``
        pages are free in the pool (or nothing evictable remains).

        A node is evictable when it is a leaf and no live sequence
        maps its page (cache holds the only reference).  ``pinned``
        pages are never evicted — the engine pins a just-matched
        prefix between lookup and allocation.
        """
        pinned = pinned or set()
        freed_total = 0
        with self._lock:
            while self.cache.free_blocks() < pages_needed:
                victim = None
                for node in self._iter_leaves(self._root):
                    if node.page in pinned:
                        continue
                    if self.cache.ref_count(node.page) != 1:
                        continue   # a live sequence still maps it
                    if victim is None or node.last_use < victim.last_use:
                        victim = node
                if victim is None:
                    break
                victim.parent.children.pop(victim.key, None)
                self._nodes -= 1
                freed_total += self.cache.decref([victim.page])
                self._evicted_pages += 1
        return freed_total

    def _iter_leaves(self, node):
        for child in node.children.values():
            if child.children:
                yield from self._iter_leaves(child)
            else:
                yield child

    # ---- telemetry ----

    def stats(self) -> Dict[str, float]:
        with self._lock:
            return {
                "prefix_nodes": self._nodes,
                "prefix_lookups": self._lookups,
                "prefix_hits": self._hits,
                "prefix_hit_tokens_total": self._hit_tokens,
                "prefix_inserted_pages": self._inserted_pages,
                "prefix_evicted_pages": self._evicted_pages,
            }

    def __len__(self) -> int:
        with self._lock:
            return self._nodes
