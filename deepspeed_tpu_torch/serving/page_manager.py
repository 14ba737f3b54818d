"""Paged KV-cache management (host side) — the port's own copy of
``deepspeed_tpu/serving/page_manager.py``, whole: the refcounted
``PagePool`` (``share``, ``ref_count``, the observer hook), per-slot
growth, release, speculative rollback (``truncate_slot``), donation
(``take_slot_pages``) and the prefix-attach / handoff adoption the
prefix cache and disaggregated serving build on (ROADMAP.md Queue A4,
A10).  Only ``default_page_size`` differs: the port's paged kernel takes
any page size.

vLLM/PagedAttention (SOSP '23): device memory holds ONE preallocated pool
of fixed-size KV pages per layer (``models/llama.init_paged_kv_cache``);
which pages belong to which sequence is pure host bookkeeping — a free
list plus a per-slot page table.  Allocation granularity is a page
(``page_size`` tokens), so the worst-case internal fragmentation is
``page_size - 1`` tokens per live sequence and external fragmentation is
zero by construction.  The engine receives ``table`` / lengths as small
int32 tensors per dispatch; this module never touches the device.
"""

import numpy as np


def default_page_size():
    """Default page size of the port's pools: 16 tokens.  The CUDA paged
    kernel takes any page size (it looks each key's page up itself), so
    small pages — finer-grained sharing of the pool — are the default."""
    return 16


class PagePoolExhausted(RuntimeError):
    """Raised when a required allocation cannot be satisfied even after
    the caller's eviction policy ran out of victims."""


class PagePool:
    """Fixed pool of fixed-size cache pages with a free list, per-page
    reference counts and allocation accounting (the reference
    counterpart is vLLM's BlockAllocator).

    Reference counting is what makes cross-request KV sharing free:
    ``allocate`` hands out pages at refcount 1, ``share`` adds a holder
    (a second slot mapping the same physical page read-only, or the
    prefix cache retaining a donated page), and ``free`` drops one
    holder — the page only returns to the free list when its last
    holder lets go.  Non-sharing callers see the plain semantics
    (allocate -> refcount 1, free -> back on the list)."""

    def __init__(self, num_pages, page_size):
        if num_pages <= 0 or page_size <= 0:
            raise ValueError("num_pages and page_size must be positive")
        self.num_pages = int(num_pages)
        self.page_size = int(page_size)
        # LIFO free list: recently freed pages are re-used first (their
        # pool slices are most likely still warm in cache hierarchies)
        self._free = list(range(self.num_pages - 1, -1, -1))
        self._refs = {}              # page id -> holder count (>= 1)
        self.peak_in_use = 0
        self.total_allocs = 0        # pages taken off the free list
        self.total_frees = 0         # pages returned to the free list
        self.total_shares = 0        # extra holders added via share()
        # memory-telemetry event hook: observer(kind, n_pages) with kind
        # in {"alloc", "free", "share"}, called AFTER the books update.
        # None by default — the off path costs one attribute load and a
        # falsy check per pool operation (pool ops are page-granular,
        # never per-token), preserving the zero-cost-when-off contract
        self.observer = None

    @property
    def free_pages(self):
        return len(self._free)

    @property
    def pages_in_use(self):
        return self.num_pages - len(self._free)

    def can_allocate(self, n):
        return n <= len(self._free)

    def ref_count(self, page):
        """Current holder count of an allocated page (0 when free)."""
        return self._refs.get(page, 0)

    def allocate(self, n):
        """Take ``n`` pages off the free list at refcount 1; raises
        PagePoolExhausted if fewer are free (callers gate with
        can_allocate / evict)."""
        if n > len(self._free):
            raise PagePoolExhausted(
                f"need {n} pages, {len(self._free)} free "
                f"({self.pages_in_use}/{self.num_pages} in use)")
        pages = [self._free.pop() for _ in range(n)]
        for p in pages:
            self._refs[p] = 1
        self.total_allocs += n
        self.peak_in_use = max(self.peak_in_use, self.pages_in_use)
        if self.observer is not None:
            self.observer("alloc", n)
        return pages

    def share(self, pages):
        """Add one holder to each already-allocated page (read-only
        prefix sharing / prefix-cache retention).  Sharing a free or
        foreign page id raises :class:`ValueError` — an unallocated
        page gaining a phantom holder would never recycle (a leak) or,
        worse, recycle under a reader."""
        # validate the WHOLE list before mutating anything: a mixed
        # good/bad list must reject atomically, or the caller — who
        # sees only the exception — would be left with phantom holders
        # it cannot account for
        for p in pages:
            if p not in self._refs:
                raise ValueError(
                    f"cannot share page {p}: not currently allocated "
                    f"(free or foreign id; pool has {self.num_pages} "
                    "pages)")
        for p in pages:
            self._refs[p] += 1
        self.total_shares += len(pages)
        if self.observer is not None:
            self.observer("share", len(pages))

    def free(self, pages):
        """Drop one holder per page; a page returns to the free list
        only when its last holder releases it.  Freeing a page that is
        not allocated — a double free, or a foreign id — raises
        :class:`ValueError` instead of silently corrupting the free
        list (a duplicate free-list entry would hand the same page to
        two owners on the next allocate)."""
        # two-pass like share(): reject the whole call before touching
        # the books, so a bad id cannot leave a half-applied free
        # behind the ValueError.  A page listed twice is legal while
        # its refcount covers both drops — count multiplicity here.
        need = {}
        for p in pages:
            need[p] = need.get(p, 0) + 1
        for p, n in need.items():
            if self._refs.get(p, 0) < n:
                raise ValueError(
                    f"cannot free page {p} x{n}: "
                    f"{self._refs.get(p, 0)} holder(s) "
                    f"(double free or foreign id; pool has "
                    f"{self.num_pages} pages)")
        freed = 0
        for p in pages:
            self._refs[p] -= 1
            if self._refs[p] == 0:
                del self._refs[p]
                self._free.append(p)
                self.total_frees += 1
                freed += 1
        if self.observer is not None and pages:
            self.observer("free", freed)

    def utilization(self):
        return self.pages_in_use / self.num_pages

    def pages_for_tokens(self, num_tokens):
        """Pages needed to hold ``num_tokens`` cache entries."""
        return -(-int(num_tokens) // self.page_size)


class PagedKVManager:
    """Per-slot page tables over one PagePool.

    ``table`` is the [num_slots, max_pages_per_slot] int32 array handed
    to the engine's decode / prefill / verify primitives each step.  Unassigned
    entries stay 0 — a *valid* page id, because gathers must stay in
    bounds; the attention mask (driven by lengths) hides them.
    """

    def __init__(self, num_pages, page_size, num_slots, max_pages_per_slot,
                 pool=None):
        # ``pool=`` shares one PagePool between several managers: the
        # disaggregated serving tier runs a prefill worker and a decode
        # worker as separate schedulers (separate slot tables) over ONE
        # physical page pool, so a prefill slot's chain can transfer to
        # a decode slot without copying a byte of KV
        if pool is None:
            pool = PagePool(num_pages, page_size)
        elif pool.num_pages != int(num_pages) or \
                pool.page_size != int(page_size):
            raise ValueError(
                f"shared pool is {pool.num_pages}x{pool.page_size}, "
                f"manager wants {num_pages}x{page_size}")
        self.pool = pool
        self.num_slots = int(num_slots)
        self.max_pages_per_slot = int(max_pages_per_slot)
        self.table = np.zeros((num_slots, max_pages_per_slot), np.int32)
        self._slot_pages = [[] for _ in range(num_slots)]

    @property
    def page_size(self):
        return self.pool.page_size

    def max_tokens_per_slot(self):
        return self.max_pages_per_slot * self.pool.page_size

    def slot_page_count(self, slot):
        return len(self._slot_pages[slot])

    def pages_needed(self, slot, target_len):
        """Additional pages ``slot`` must allocate to hold positions
        < target_len (0 when already covered).  The serving scheduler's
        horizon pre-reservation sums this across running slots to decide
        whether a fused multi-step decode fits in free pages before
        dispatching it."""
        return max(0, self.pool.pages_for_tokens(target_len) -
                   len(self._slot_pages[slot]))

    def ensure_capacity(self, slot, target_len):
        """Grow ``slot``'s table until positions < target_len are
        writable. Returns True on success; False when the pool is out of
        pages (caller decides eviction).  Raises when target_len exceeds
        the per-slot table (a config error, not a transient)."""
        needed = self.pool.pages_for_tokens(target_len)
        if needed > self.max_pages_per_slot:
            raise ValueError(
                f"sequence of {target_len} tokens needs {needed} pages > "
                f"max_pages_per_slot={self.max_pages_per_slot}")
        have = len(self._slot_pages[slot])
        if needed <= have:
            return True
        if not self.pool.can_allocate(needed - have):
            return False
        new = self.pool.allocate(needed - have)
        for i, p in enumerate(new):
            self.table[slot, have + i] = p
        self._slot_pages[slot].extend(new)
        return True

    def attach_prefix(self, slot, pages):
        """Map a cached page chain read-only into an EMPTY slot's table
        (prefix-cache hit): each page gains one holder — the slot — on
        top of the cache's own reference, so neither a slot release nor
        a cache eviction alone can recycle a page the other still needs.
        The slot must never write positions below the attached boundary
        (``len(pages) * page_size`` tokens); the scheduler guarantees
        this by resuming prefill/decode at that boundary."""
        if self._slot_pages[slot]:
            raise ValueError(
                f"slot {slot} already holds pages; prefix attach must "
                "seed an empty slot")
        if len(pages) > self.max_pages_per_slot:
            raise ValueError(
                f"prefix of {len(pages)} pages > max_pages_per_slot="
                f"{self.max_pages_per_slot}")
        self.pool.share(pages)
        for i, p in enumerate(pages):
            self.table[slot, i] = p
        self._slot_pages[slot] = list(pages)

    def adopt_chain(self, slot, pages):
        """Seed an EMPTY slot with an already-owned page chain (the
        prefill->decode KV handoff: a prefill worker's
        ``take_slot_pages`` detached the chain with its pool references
        intact, and adoption transfers that ownership to this slot —
        unlike :meth:`attach_prefix`, NO new holder is added, because
        the chain changes hands rather than gaining a reader)."""
        if self._slot_pages[slot]:
            raise ValueError(
                f"slot {slot} already holds pages; a handoff chain must "
                "seed an empty slot")
        if len(pages) > self.max_pages_per_slot:
            raise ValueError(
                f"handoff chain of {len(pages)} pages > "
                f"max_pages_per_slot={self.max_pages_per_slot}")
        for i, p in enumerate(pages):
            self.table[slot, i] = p
        self._slot_pages[slot] = list(pages)

    def adopt_page(self, slot, page):
        """Append an already-allocated page to a slot's chain (the
        copy-on-write private copy of a partially matched cached page:
        allocated fresh, filled by the engine's page-copy primitive,
        then owned by the slot like any grown page)."""
        have = len(self._slot_pages[slot])
        if have >= self.max_pages_per_slot:
            raise ValueError(
                f"slot {slot} page chain full "
                f"(max_pages_per_slot={self.max_pages_per_slot})")
        self.table[slot, have] = page
        self._slot_pages[slot].append(page)

    def truncate_slot(self, slot, new_len):
        """Rewind ``slot`` to ``new_len`` tokens (speculative-decode KV
        rollback): pages that fall ENTIRELY past the new boundary leave
        the slot's chain and drop one holder each (``pool.free`` — a
        page the prefix cache or another slot still references survives
        under its remaining holders; only refcount-0 pages recycle).
        The boundary page keeps its stale tail: positions >= new_len
        are overwritten before any later gather can read them, or
        masked out by the attention's length-driven validity mask.
        Returns the number of page references released."""
        keep = self.pool.pages_for_tokens(new_len)
        pages = self._slot_pages[slot]
        if keep >= len(pages):
            return 0
        drop = pages[keep:]
        del pages[keep:]
        self.table[slot, keep:keep + len(drop)] = 0
        self.pool.free(drop)
        return len(drop)

    def take_slot_pages(self, slot):
        """Detach and return a slot's page chain WITHOUT releasing the
        pool references (retirement donating pages to the prefix cache:
        ownership of each page's reference transfers to the caller, who
        either hands it to the cache or frees it)."""
        pages = self._slot_pages[slot]
        self._slot_pages[slot] = []
        self.table[slot, :] = 0
        return pages

    def release_slot(self, slot):
        """Drop the slot's hold on all of its pages (sequence retired or
        preempted); pages shared with the prefix cache stay allocated
        under the cache's reference."""
        pages = self._slot_pages[slot]
        self.pool.free(pages)
        self._slot_pages[slot] = []
        self.table[slot, :] = 0
        return len(pages)

    def utilization(self):
        return self.pool.utilization()
