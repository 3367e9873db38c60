"""Paged KV cache: the host-side page allocator (port of
deepspeed_tpu/inference/kv_cache.py).

One preallocated pool of fixed-size pages

    k_pool / v_pool : [n_layer, num_pages, page_size, n_head, head_dim]

is shared by every request (the tensors live in the engine's state);
each request slot owns a page-table row, and positions map to
(physical page, offset) by index math on the device. Physical page 0
is a reserved scratch page: masked writes (inactive decode slots) go
there instead of being predicated away.

Allocation is host-side and happens only at serving fences. Admission
reserves a request's worst-case page count up front (`can_admit`), so
an admitted request never fails an allocation mid-flight; pages are
still assigned incrementally as the sequence grows.

Speculative decoding's draft model keeps its K/V in a second pool with
the draft's layer count (`attach_draft`) that shares these page tables
and this allocator: one admission decision, one table upload. A
rejected suffix is undone by `rollback`, which trims a slot's pages to
its committed length without touching page data: stale K/V beyond a
slot's position is masked and value-zeroed by the engine's attention.

Ledger integration (monitor/memory.py): the pool registers itself under
the `kv_cache` category — one dynamic `pool.unallocated` entry plus one
dynamic entry per live request — so the category total always equals
the true preallocated pool bytes while `top_buffers` and the category
meta give per-request attribution; the draft pool does the same under
`kv_cache_draft` in draft page bytes.
"""

import numpy as np
import torch

from deepspeed_tpu_torch.monitor import memory as memory_mod


def _itemsize(dtype):
    """Bytes per element of a torch or numpy dtype."""
    if isinstance(dtype, torch.dtype):
        return dtype.itemsize
    return np.dtype(dtype).itemsize


class PagedKVCache:
    """Host-side page allocator + pool geometry for one engine. The page
    tables (`tables`, numpy) are the source of truth that the engine
    uploads after fence-side mutations (`table_version` bumps on every
    mutation)."""

    def __init__(self, n_layer, n_head, head_dim, num_pages, page_size,
                 max_slots, max_pages_per_slot, dtype=np.float32,
                 ledger=None):
        if max_pages_per_slot < 1:
            raise ValueError(
                f"max_pages_per_slot must be >= 1, got {max_pages_per_slot}")
        if num_pages < 2:
            raise ValueError(
                f"num_pages must be >= 2 (page 0 is the reserved scratch "
                f"page), got {num_pages}")
        self.n_layer = int(n_layer)
        self.n_head = int(n_head)
        self.head_dim = int(head_dim)
        self.num_pages = int(num_pages)
        self.page_size = int(page_size)
        self.max_slots = int(max_slots)
        self.max_pages_per_slot = int(max_pages_per_slot)
        self.itemsize = _itemsize(dtype)
        # bytes of ONE page across K+V and all layers
        self.page_bytes = (2 * self.n_layer * self.page_size * self.n_head *
                           self.head_dim * self.itemsize)
        self.pool_bytes = self.num_pages * self.page_bytes
        # page 0 = scratch; pages 1..num_pages-1 allocatable (LIFO free
        # list: recently freed pages are re-assigned first)
        self._free = list(range(self.num_pages - 1, 0, -1))
        self._reserved = {}        # slot -> reserved page credit (int)
        self._pages = {}           # slot -> [physical page ids]
        self._names = {}           # slot -> ledger entry name
        self.tables = np.zeros((self.max_slots, self.max_pages_per_slot),
                               np.int32)
        self.table_version = 0
        self._ledger = ledger
        self._ledger_tokens = {}
        # the speculative draft pool (attach_draft): same tables and
        # allocator, the draft's layer count
        self.draft_n_layer = 0
        self.draft_page_bytes = 0
        self.draft_pool_bytes = 0
        self._draft_ledger_tokens = {}
        if ledger is not None:
            ledger.register_dynamic(
                memory_mod.CAT_KV, "pool.unallocated",
                lambda: self.pool_bytes - self.allocated_bytes(),
                meta={"num_pages": self.num_pages,
                      "page_size": self.page_size})

    def attach_draft(self, n_layer_draft):
        """Declare the speculative draft model's KV pool: it shares this
        cache's page tables and free list, so the only new accounting is
        its bytes, the flagship's page bytes scaled to the draft's layer
        count."""
        self.draft_n_layer = int(n_layer_draft)
        self.draft_page_bytes = (2 * self.draft_n_layer * self.page_size *
                                 self.n_head * self.head_dim * self.itemsize)
        self.draft_pool_bytes = self.num_pages * self.draft_page_bytes
        if self._ledger is not None:
            self._ledger.register_dynamic(
                memory_mod.CAT_KV_DRAFT, "pool.unallocated",
                lambda: self.draft_pool_bytes -
                self.pages_in_use() * self.draft_page_bytes,
                meta={"num_pages": self.num_pages,
                      "page_size": self.page_size,
                      "n_layer_draft": self.draft_n_layer})

    # -- accounting -----------------------------------------------------
    def pages_for_tokens(self, n_tokens):
        """Pages needed to hold positions [0, n_tokens)."""
        return -(-int(n_tokens) // self.page_size)

    def free_pages(self):
        return len(self._free)

    def reserved_unallocated(self):
        """Pages promised to admitted requests but not yet assigned."""
        return sum(max(self._reserved[s] - len(p), 0)
                   for s, p in self._pages.items())

    def slots(self):
        """Admitted slot ids (live requests)."""
        return list(self._pages)

    def reserved_tokens(self, slot):
        """Token capacity of `slot`'s admission reservation."""
        return self._reserved.get(slot, 0) * self.page_size

    def allocated_pages(self, slot):
        return len(self._pages.get(slot, ()))

    def slot_bytes(self, slot):
        return self.allocated_pages(slot) * self.page_bytes

    def allocated_bytes(self):
        return self.pages_in_use() * self.page_bytes

    def pages_in_use(self):
        """Pages currently assigned to live requests."""
        return sum(len(p) for p in self._pages.values())

    def draft_slot_bytes(self, slot):
        """The draft pool's bytes behind `slot`'s pages (0 without a
        draft)."""
        return self.allocated_pages(slot) * self.draft_page_bytes

    # -- admission / growth / release -----------------------------------
    def can_admit(self, n_tokens_worst_case):
        """True when a request that may grow to n_tokens_worst_case
        positions fits: its worst-case pages AND every other live
        request's still-unassigned reservation must be coverable by the
        free list."""
        need = self.pages_for_tokens(n_tokens_worst_case)
        if need > self.max_pages_per_slot:
            return False
        return need + self.reserved_unallocated() <= len(self._free)

    def admit(self, slot, n_tokens_worst_case, name=None):
        """Reserve worst-case capacity for `slot` (no pages assigned
        yet) and open its ledger entries."""
        if slot in self._pages or slot in self._reserved:
            raise ValueError(f"slot {slot} is already admitted")
        if not self.can_admit(n_tokens_worst_case):
            raise RuntimeError(
                f"kv cache cannot admit {n_tokens_worst_case} tokens: "
                f"{len(self._free)} free pages, "
                f"{self.reserved_unallocated()} already reserved "
                "(raise inference.kv_cache.num_pages)")
        self._reserved[slot] = self.pages_for_tokens(n_tokens_worst_case)
        self._pages[slot] = []
        self._names[slot] = name or f"slot{slot}"
        if self._ledger is not None:
            # the slot id keys the entry: request ids are caller-chosen
            # and two live requests may share one
            self._ledger_tokens[slot] = self._ledger.register_dynamic(
                memory_mod.CAT_KV, f"request.s{slot}.{self._names[slot]}",
                (lambda s: lambda: self.slot_bytes(s))(slot),
                meta={"slot": int(slot), "request": self._names[slot]})
            if self.draft_n_layer:
                self._draft_ledger_tokens[slot] = \
                    self._ledger.register_dynamic(
                        memory_mod.CAT_KV_DRAFT,
                        f"request.s{slot}.{self._names[slot]}",
                        (lambda s: lambda: self.draft_slot_bytes(s))(slot),
                        meta={"slot": int(slot),
                              "request": self._names[slot]})

    def ensure(self, slot, n_tokens):
        """Assign pages so `slot` can hold positions [0, n_tokens).
        Within the admission reservation this cannot fail; beyond it,
        it raises."""
        if slot not in self._pages:
            raise ValueError(f"slot {slot} is not admitted")
        need = self.pages_for_tokens(n_tokens)
        pages = self._pages[slot]
        if need > self._reserved[slot]:
            raise RuntimeError(
                f"slot {slot}: {n_tokens} tokens exceeds the admission "
                f"reservation of {self._reserved[slot]} pages")
        while len(pages) < need:
            phys = self._free.pop()
            pages.append(phys)
            self.tables[slot, len(pages) - 1] = phys
            self.table_version += 1
        return pages

    def rollback(self, slot, n_tokens):
        """Rewind `slot` to exactly the pages needed for positions
        [0, n_tokens): the rejected-suffix rollback of speculative
        decoding. No page data is copied or cleared (the device-side
        kv_limit, the slot's position, masks stale K/V): trimmed pages go
        back on the LIFO free list, so a re-advance pops the same
        physical pages into the same table columns, and the freed
        columns reset to the scratch page. Returns the number of pages
        released; a rollback that trims nothing changes nothing (no
        table_version bump, no upload)."""
        if slot not in self._pages:
            raise ValueError(f"slot {slot} is not admitted")
        need = self.pages_for_tokens(n_tokens)
        pages = self._pages[slot]
        if need >= len(pages):
            return 0
        freed = pages[need:]
        del pages[need:]
        # reversed: the highest-position page ends up on top of the LIFO
        # list, so regrowth reassigns page for page identically
        self._free.extend(reversed(freed))
        self.tables[slot, need:need + len(freed)] = 0
        self.table_version += 1
        return len(freed)

    def free(self, slot):
        """Return `slot`'s pages to the free list, drop its reservation,
        close its ledger entries and reset its table row to the scratch
        page."""
        pages = self._pages.pop(slot, [])
        self._free.extend(reversed(pages))
        self._reserved.pop(slot, None)
        self._names.pop(slot, None)
        self.tables[slot, :] = 0
        self.table_version += 1
        for tokens in (self._ledger_tokens, self._draft_ledger_tokens):
            token = tokens.pop(slot, None)
            if token is not None and self._ledger is not None:
                self._ledger.release(token)
        return len(pages)
