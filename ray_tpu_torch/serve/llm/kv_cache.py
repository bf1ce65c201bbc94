"""Paged (block) KV cache: the allocator behind continuous batching.

Counterpart of ``ray_tpu/serve/llm/kv_cache.py``, copied as plain
Python. Reference analogue: vLLM's BlockSpaceManager. The cache is a
fixed pool of fixed-size pages; each sequence
owns a *block table* mapping its logical token positions to physical
pages. Growing a sequence by one token allocates at most one page;
finishing a sequence returns all its pages to the free list instantly.
Admission control is therefore exact: a prompt of L tokens with a
budget of G generated tokens needs ``ceil((L + G) / block_size)``
pages, and the engine refuses to admit what it cannot finish —
sequences never deadlock mid-decode waiting for pages.

Page 0 is reserved as the *null page*: batch-padding rows point every
block-table entry at it, so padded jit steps scatter their garbage
into scratch instead of a live sequence's memory.

Pages are *refcounted* so the radix prefix cache (prefix_cache.py) can
share read-only prompt pages across sequences: ``allocate_with_prefix``
maps a cached prefix into a new sequence's block table by bumping the
shared pages' refcounts, ``copy_on_write`` gives a sequence a private
copy of a shared page before it writes into it, and a page returns to
the free list only when its last reference (sequence table or cache
branch) drops.

The pool itself is storage-agnostic — the allocator tracks only
indices, so the same bookkeeping serves the numpy toy adapter and the
torch adapter's per-layer page tensors.
"""

from __future__ import annotations

import threading
from typing import Dict, Iterable, List, Optional, Tuple


class OutOfKVBlocksError(Exception):
    """The pool cannot satisfy an allocation — the engine keeps the
    sequence WAITING (or sheds it) rather than admitting work it
    cannot finish."""


class PagedKVCache:
    """Block allocator + occupancy accounting for one replica's pool.

    Thread-safe: the engine thread allocates/frees while actor threads
    read occupancy for admission and telemetry.
    """

    def __init__(self, num_blocks: int, block_size: int):
        if num_blocks < 2:
            raise ValueError("need >= 2 blocks (page 0 is reserved)")
        self.num_blocks = int(num_blocks)
        self.block_size = int(block_size)
        # page 0 reserved as the null/scratch page for padding rows
        self._free: List[int] = list(range(self.num_blocks - 1, 0, -1))
        self._tables: Dict[str, List[int]] = {}   # seq id -> pages
        self._refs: Dict[int, int] = {}           # page -> reference count
        self._lock = threading.Lock()

    # ---- sizing ----

    def blocks_for(self, num_tokens: int) -> int:
        return max(1, -(-int(num_tokens) // self.block_size))

    def can_allocate(self, num_tokens: int) -> bool:
        with self._lock:
            return len(self._free) >= self.blocks_for(num_tokens)

    def free_blocks(self) -> int:
        with self._lock:
            return len(self._free)

    # ---- allocation ----

    def allocate(self, seq_id: str, num_tokens: int) -> List[int]:
        """Reserve every page a sequence will ever need (prompt +
        generation budget) up front — exact admission, no mid-decode
        OOM."""
        need = self.blocks_for(num_tokens)
        with self._lock:
            if seq_id in self._tables:
                raise ValueError(f"sequence {seq_id!r} already allocated")
            if len(self._free) < need:
                raise OutOfKVBlocksError(
                    f"need {need} KV blocks, {len(self._free)} free "
                    f"(pool {self.num_blocks - 1})")
            pages = [self._free.pop() for _ in range(need)]
            for p in pages:
                self._refs[p] = 1
            self._tables[seq_id] = pages
            return list(pages)

    def allocate_with_prefix(self, seq_id: str, num_tokens: int,
                             shared_pages: List[int]) -> List[int]:
        """Admit a sequence whose leading pages are already resident:
        the shared (read-only) pages are mapped into the new block
        table by refcount, and only the remainder comes from the free
        list.  The caller must not write into a shared page without
        ``copy_on_write`` first."""
        need = self.blocks_for(num_tokens)
        n_shared = len(shared_pages)
        if n_shared > need:
            raise ValueError(
                f"prefix covers {n_shared} pages but sequence needs {need}")
        fresh_need = need - n_shared
        with self._lock:
            if seq_id in self._tables:
                raise ValueError(f"sequence {seq_id!r} already allocated")
            for p in shared_pages:
                if self._refs.get(p, 0) <= 0:
                    raise ValueError(f"shared page {p} is not live")
            if len(self._free) < fresh_need:
                raise OutOfKVBlocksError(
                    f"need {fresh_need} fresh KV blocks "
                    f"({n_shared} shared), {len(self._free)} free")
            for p in shared_pages:
                self._refs[p] += 1
            fresh = [self._free.pop() for _ in range(fresh_need)]
            for p in fresh:
                self._refs[p] = 1
            pages = list(shared_pages) + fresh
            self._tables[seq_id] = pages
            return list(pages)

    def incref(self, pages: Iterable[int]) -> None:
        """Take an extra reference on live pages (prefix-cache branch
        adoption)."""
        with self._lock:
            for p in pages:
                if self._refs.get(p, 0) <= 0:
                    raise ValueError(f"page {p} is not live")
                self._refs[p] += 1

    def decref(self, pages: Iterable[int]) -> int:
        """Drop one reference per page; pages whose count hits zero go
        back to the free list.  Returns how many were actually freed."""
        with self._lock:
            return self._decref_locked(pages)

    def _decref_locked(self, pages: Iterable[int]) -> int:
        freed = 0
        for p in pages:
            n = self._refs.get(p, 0)
            if n <= 0:
                continue
            if n == 1:
                del self._refs[p]
                self._free.append(p)
                freed += 1
            else:
                self._refs[p] = n - 1
        return freed

    def copy_on_write(self, seq_id: str, index: int) -> Tuple[int, int]:
        """Give ``seq_id`` a private copy of block-table entry ``index``
        before it writes into it.  Returns ``(old_page, new_page)`` —
        equal when the page was already private (nothing to do); the
        caller copies the page *contents* old→new when they differ."""
        with self._lock:
            table = self._tables.get(seq_id)
            if table is None or index >= len(table):
                raise ValueError(f"no block {index} for {seq_id!r}")
            old = table[index]
            if self._refs.get(old, 0) <= 1:
                return (old, old)
            if not self._free:
                raise OutOfKVBlocksError(
                    "copy-on-write needs 1 free KV block, 0 free")
            new = self._free.pop()
            self._refs[new] = 1
            self._refs[old] -= 1
            table[index] = new
            return (old, new)

    def ref_count(self, page: int) -> int:
        with self._lock:
            return self._refs.get(page, 0)

    def free(self, seq_id: str) -> int:
        """Drop a finished sequence's references; pages still shared
        with the prefix cache or other sequences stay resident, the
        rest are admittable on the very next engine step."""
        with self._lock:
            pages = self._tables.pop(seq_id, None)
            if not pages:
                return 0
            return self._decref_locked(pages)

    def block_table(self, seq_id: str) -> Optional[List[int]]:
        with self._lock:
            t = self._tables.get(seq_id)
            return list(t) if t else None

    # ---- telemetry (autoscaler signal: docs/LLM_SERVING.md) ----

    def occupancy(self) -> float:
        """Fraction of the usable pool currently owned by sequences."""
        with self._lock:
            usable = self.num_blocks - 1
            return (usable - len(self._free)) / max(1, usable)

    def stats(self) -> Dict[str, float]:
        with self._lock:
            usable = self.num_blocks - 1
            used = usable - len(self._free)
            return {"kv_blocks_total": usable,
                    "kv_blocks_used": used,
                    "kv_block_size": self.block_size,
                    "kv_occupancy": used / max(1, usable),
                    "kv_sequences": len(self._tables)}
