"""Radix prefix cache: refcounted, copy-on-write KV page sharing — the
port's own copy of ``deepspeed_tpu/serving/prefix_cache.py`` (host-only:
``hashlib`` and numpy), whole, namespaces, ``fingerprint`` and
``prefix_digest`` included, so tenancy and the prefix-aware router find
them when they are ported (ROADMAP.md Queue A10).

Device-agnostic by contract: the trie stores page ids and token keys,
never device placement; the copy-on-write copy is the engine's
``copy_page``, which moves one index of the page dim of every pool leaf
in place.  No code here touches a tensor.

SGLang's RadixAttention (Zheng et al., 2024) on top of the paged KV
pool: a page-granular radix/trie index maps token-ID sequences to
chains of *full, immutable* KV pages left behind by finished requests.
Admission does a longest-prefix match against a new prompt; matched
pages are mapped read-only into the slot's page table (``PagePool``
refcounts make the sharing safe) and chunked prefill resumes from the
cached boundary — prefill FLOPs and page footprint become proportional
to *unique* tokens, not total tokens.

Structure: every tree node owns exactly ONE full page and is keyed by
that page's ``page_size`` token IDs, so the path from the root to a
node spells the exact token sequence whose KV the node's page chain
holds.  That is the cache-coherence invariant: **a chain is keyed by
exact token IDs — any mismatch is a miss, never a wrong-KV hit.**  KV
entries are position-dependent (rotary/ALiBi are applied at absolute
positions), but a prefix always starts at position 0, so equal token
chains imply bitwise-equal cached KV.

Lifecycle:

* **donate** — a finished request's full pages are inserted (ownership
  of the slot's pool reference transfers to the cache); duplicate
  chains keep the incumbent page and return the donor's copy for
  release.  A ``max_pages`` cap bounds retention.
* **match/acquire** — longest-prefix lookup; acquired pages gain one
  holder per sharing slot (``pool.share``).  A *partially* matched page
  is never shared in place: the caller copies it into a fresh private
  page on-device (copy-on-write) before any position in it may be
  overwritten.
* **evict** — cached pages are reclaimable capacity, never a leak:
  under pool pressure, leaves whose only holder is the cache are
  evicted in LRU order (interior nodes become evictable as their
  subtrees drain).  ``PagePoolExhausted`` is only terminal after the
  cache is drained.
"""

import hashlib

import numpy as np

# namespace sentinel meaning "every namespace" (None is a real
# namespace: the legacy single-tenant root)
ALL_NAMESPACES = object()


class _Node:
    """One cached page: ``key`` is the exact ``page_size`` token IDs
    whose KV the page holds; the root is a keyless sentinel."""

    __slots__ = ("key", "page", "parent", "children", "last_used")

    def __init__(self, key=None, page=None, parent=None):
        self.key = key
        self.page = page
        self.parent = parent
        self.children = {}           # key tuple -> _Node
        self.last_used = 0


class PrefixCache:
    """Page-granular radix index over one :class:`PagePool`."""

    def __init__(self, pool, max_pages=None, min_partial_tokens=None):
        self.pool = pool
        self.page_size = pool.page_size
        self.max_pages = pool.num_pages if max_pages is None \
            else int(max_pages)
        # a partial (copy-on-write) hit must reuse at least this many
        # tokens to be worth the on-device page copy + fresh page: a
        # 1-token accidental match must not pay a whole-page dispatch.
        # Default: a quarter page (1 at tiny page sizes).
        if min_partial_tokens is None:
            min_partial_tokens = self.page_size // 4
        self.min_partial_tokens = max(1, int(min_partial_tokens))
        # one radix root per namespace (multi-tenant isolation): the
        # namespace is part of every lookup/insert key, so one tenant's
        # donated KV can never hit another's prompt.  ``None`` is the
        # legacy single-tenant namespace — every default path behaves
        # exactly as before.
        self._roots = {None: _Node()}
        self._nodes = 0              # == cached pages held by the index
        self._clock = 0              # LRU timestamp source
        # observability (the scheduler folds these into ServingMetrics)
        self.lookups = 0
        self.hits = 0
        self.tokens_reused = 0
        self.pages_shared = 0
        self.cow_copies = 0
        self.donated_pages = 0
        self.evicted_pages = 0

    @property
    def cached_pages(self):
        return self._nodes

    @property
    def _root(self):
        # legacy single-tenant trie root (pre-namespace alias; the
        # coherence walks in the serving test suites traverse it)
        return self._roots[None]

    def _touch(self, node):
        self._clock += 1
        node.last_used = self._clock

    def _root_for(self, ns, create=False):
        root = self._roots.get(ns)
        if root is None and create:
            root = self._roots[ns] = _Node()
        return root

    def _iter_roots(self, ns):
        if ns is ALL_NAMESPACES:
            return list(self._roots.items())
        root = self._roots.get(ns)
        return [] if root is None else [(ns, root)]

    def ns_pages(self, ns):
        """Cached pages held under ONE namespace (the tenant quota
        ledger counts these against the owning tenant)."""
        root = self._roots.get(ns)
        if root is None:
            return 0
        count, stack = 0, list(root.children.values())
        while stack:
            n = stack.pop()
            stack.extend(n.children.values())
            count += 1
        return count

    # ------------------------------------------------------------- match
    def match(self, tokens, limit=None, ns=None):
        """Longest-prefix match of ``tokens[:limit]`` against the index.

        Returns ``(full_nodes, partial_node, partial_len)``:
        ``full_nodes`` is the chain of wholly matched pages (their pages
        cover ``tokens[:len(full_nodes) * page_size]`` exactly);
        ``partial_node``, when set, matches ``partial_len`` further
        tokens at the start of its page (the copy-on-write candidate).
        ``limit`` caps the usable prefix — the scheduler passes
        ``len(prompt) - 1`` so at least one prompt token always remains
        to prefill (the boundary logits the first sampled token needs).
        Pure lookup: no refcounts move, no LRU touch, no stats — the
        hit/lookup counters advance once per ADMISSION (the scheduler's
        attach), not per attempt, so a capacity-blocked request re-
        matched every step cannot inflate the hit rate."""
        ps = self.page_size
        if limit is None:
            limit = len(tokens)
        limit = min(limit, len(tokens))
        root = self._roots.get(ns)
        if root is None:
            return [], None, 0
        node, full_nodes, i = root, [], 0
        while i + ps <= limit:
            child = node.children.get(tuple(int(t) for t in
                                            tokens[i:i + ps]))
            if child is None:
                break
            full_nodes.append(child)
            node = child
            i += ps
        partial_node, partial_len = None, 0
        rest = [int(t) for t in tokens[i:limit]]
        if rest:
            for key, child in node.children.items():
                n = 0
                while n < len(rest) and key[n] == rest[n]:
                    n += 1
                if n > partial_len:
                    partial_node, partial_len = child, n
            if partial_len < self.min_partial_tokens:
                partial_node, partial_len = None, 0
        return full_nodes, partial_node, partial_len

    def acquire(self, nodes):
        """Hand the matched chain's pages to a slot attach: the whole
        path is LRU-touched and the share is counted.  The caller
        (``PagedKVManager.attach_prefix``) takes the pool reference —
        exactly ONE holder per sharing slot."""
        pages = [n.page for n in nodes]
        for n in nodes:
            self._touch(n)
        self.pages_shared += len(pages)
        return pages

    def touch(self, node):
        """LRU-touch without sharing (the copy-on-write path reads a
        cached page but maps a private copy, so no reference moves)."""
        self._touch(node)

    # ------------------------------------------------------------ donate
    def insert(self, tokens, pages, ns=None):
        """Donate a finished request's full pages: ``pages[j]`` holds
        the KV of ``tokens[j*ps : (j+1)*ps]``.  The caller transfers
        ownership of each page's pool reference; pages the cache does
        NOT keep (duplicate chains, cap overflow) are returned for the
        caller to free.  Never triggers pool allocation."""
        ps = self.page_size
        node, leftover = self._root_for(ns, create=True), []
        for j, page in enumerate(pages):
            key = tuple(int(t) for t in tokens[j * ps:(j + 1) * ps])
            child = node.children.get(key)
            if child is not None:
                # chain already cached: keep the incumbent page (other
                # slots may share it), hand the donor's copy back
                leftover.append(page)
                node = child
                self._touch(node)
                continue
            if self._nodes >= self.max_pages and \
                    not self._evict_lru(protect=self._path(node)):
                leftover.extend(pages[j:])
                return leftover
            child = _Node(key, page, parent=node)
            node.children[key] = child
            node = child
            self._nodes += 1
            self.donated_pages += 1
            self._touch(node)
        return leftover

    def _path(self, node):
        out = set()
        while node is not None and node.key is not None:
            out.add(id(node))
            node = node.parent
        return out

    # ------------------------------------------------------------- evict
    def _evictable(self, protect, ns=ALL_NAMESPACES):
        """Leaves whose only holder is the cache itself (live slots add
        holders via acquire, making their chains un-evictable).
        ``ns`` scopes the sweep to ONE namespace (a tenant at quota
        drains only its own pages); the default sweeps every root."""
        out = []
        stack = [root for _, root in self._iter_roots(ns)]
        while stack:
            n = stack.pop()
            stack.extend(n.children.values())
            if n.key is not None and not n.children and \
                    id(n) not in protect and \
                    self.pool.ref_count(n.page) == 1:
                out.append(n)
        return out

    def _evict_lru(self, protect=frozenset()):
        """Free ONE cached page (the least recently used evictable
        leaf).  Returns True when a page was reclaimed."""
        return self.evict(1, protect) == 1

    def evict(self, n_pages, protect=frozenset(), ns=ALL_NAMESPACES):
        """Reclaim up to ``n_pages`` cached pages, LRU-first.  Each pass
        collects the CURRENT evictable leaves once and drains them in
        LRU order; interior nodes exposed by a pass become candidates in
        the next (a parent can never leave before its children anyway,
        so per-pass batching keeps the policy LRU-within-a-layer while
        a full drain stays O(depth x tree) instead of O(pages x tree)).
        Returns the number of pages actually freed."""
        freed = 0
        while freed < n_pages:
            victims = self._evictable(protect, ns)
            if not victims:
                break
            victims.sort(key=lambda n: n.last_used)
            for victim in victims:
                if freed >= n_pages:
                    break
                del victim.parent.children[victim.key]
                self.pool.free([victim.page])
                self._nodes -= 1
                self.evicted_pages += 1
                freed += 1
        return freed

    def reclaimable_pages(self, protect=frozenset(), ns=ALL_NAMESPACES):
        """EXACTLY how many pages ``evict(..., protect)`` can free right
        now: a node is drainable only when the cache is its sole holder,
        it is not protected, AND its whole subtree is drainable — a
        parent can only leave after its children, so one shared (or
        protected) descendant pins its entire ancestor chain.  Capacity
        planners (horizon shrink, admission, chaining) rely on this
        being achievable, not an upper bound: phantom capacity here
        would suppress horizon shrink and convert it into a
        live-request preemption.  Iterative post-order — chain depth is
        unbounded (one page per ``page_size`` tokens of the longest
        donated sequence) and this runs inside the serving loop."""
        total = 0
        for _, root in self._iter_roots(ns):
            results = {}              # id(node) -> (count, drainable)
            stack = [(root, False)]
            while stack:
                node, visited = stack.pop()
                if not visited:
                    stack.append((node, True))
                    stack.extend((c, False)
                                 for c in node.children.values())
                    continue
                count, ok = 0, True
                for child in node.children.values():
                    c_count, c_ok = results.pop(id(child))
                    count += c_count
                    ok = ok and c_ok
                if node.key is not None:
                    if ok and id(node) not in protect and \
                            self.pool.ref_count(node.page) == 1:
                        count += 1
                    else:
                        ok = False
                results[id(node)] = (count, ok)
            total += results[id(root)][0]
        return total

    def iter_pages(self):
        """Every page id the trie currently holds one pool reference
        for (one per node, across all namespaces) — the census the
        memory-telemetry auditor (``serving/mem_telemetry.audit_pool``)
        and page-state classifier sweep.  Pure iterative walk, no
        refcounts move."""
        stack = [c for _, root in self._iter_roots(ALL_NAMESPACES)
                 for c in root.children.values()]
        while stack:
            n = stack.pop()
            stack.extend(n.children.values())
            yield n.page

    def ns_iter_pages(self, ns):
        """``iter_pages`` scoped to one namespace (the per-tenant page
        attribution sweep in ``mem_telemetry.classify``)."""
        root = self._roots.get(ns)
        stack = [] if root is None else list(root.children.values())
        while stack:
            n = stack.pop()
            stack.extend(n.children.values())
            yield n.page

    def prefix_len(self, tokens, limit=None, ns=None):
        """Fingerprint export for the cluster router: how many leading
        tokens of ``tokens`` this cache could serve RIGHT NOW (whole
        matched pages plus the best copy-on-write partial).  Pure
        lookup — no refcounts move, no LRU touch, no stats — so the
        prefix-aware router can score every replica per admission
        without perturbing any cache."""
        full, _, plen = self.match(tokens, limit=limit, ns=ns)
        return len(full) * self.page_size + plen

    def hit_rate(self):
        return self.hits / self.lookups if self.lookups else 0.0

    def fingerprint(self, max_digests=4096):
        """Wire-portable digest of what this cache could serve: one
        :func:`prefix_digest` per cached page-aligned prefix (every
        trie node digests the FULL token path from the root through
        it), plus the raw hit counters.  A worker ships this at
        heartbeat cadence / on the ``fingerprint`` protocol op; the
        router-side :class:`FingerprintMatcher` then scores a
        ``ProcessReplica`` for a prompt exactly like ``prefix_len``
        scores an in-process replica — page-granular (the remote
        copy-on-write partial isn't representable in a digest set,
        and routing only needs the page-aligned score).  Pure walk:
        no refcounts, no LRU touches."""
        digests = []
        stack = [(root, (), ns) for ns, root in
                 self._iter_roots(ALL_NAMESPACES)]
        while stack and len(digests) < max_digests:
            node, path, ns = stack.pop()
            for key, child in node.children.items():
                child_path = path + key
                # the namespace salts the digest, so a router matching
                # tenant A's prompt can never score a hit against
                # tenant B's cached pages — the isolation invariant
                # holds over the wire too
                digests.append(prefix_digest(child_path, ns=ns))
                stack.append((child, child_path, ns))
        return {"page_size": self.page_size, "digests": digests,
                "lookups": self.lookups, "hits": self.hits,
                "tokens_reused": self.tokens_reused}


def prefix_digest(tokens, ns=None):
    """Deterministic cross-process digest of a token prefix: blake2b
    over the little-endian int32 token bytes.  NOT Python ``hash()``
    — that is seed-randomized per process, and the whole point is
    that the router and a worker compute identical digests.  A
    non-None namespace (multi-tenant isolation) salts the digest, so
    equal prompts in different namespaces digest differently; the
    ``None`` namespace keeps the legacy unsalted bytes (mixed-version
    fleets keep matching)."""
    h = hashlib.blake2b(digest_size=8)
    if ns is not None:
        h.update(repr(ns).encode("utf-8") + b"\x00")
    h.update(np.asarray(tokens, "<i4").tobytes())
    return h.hexdigest()


class FingerprintMatcher:
    """Router-side view of a remote worker's prefix cache, built from
    shipped :meth:`PrefixCache.fingerprint` payloads.  ``match_len``
    is the wire twin of ``PrefixCache.prefix_len``: the longest
    page-aligned cached prefix of a prompt, in tokens."""

    def __init__(self):
        self.page_size = 0
        self._digests = frozenset()
        self.lookups = 0
        self.hits = 0
        self.tokens_reused = 0

    def update(self, fp):
        """Absorb one shipped fingerprint (latest wins — the cache
        mutates between heartbeats and stale entries only cost a
        slightly off score, never correctness)."""
        self.page_size = int(fp.get("page_size", 0) or 0)
        self._digests = frozenset(fp.get("digests", ()))
        self.lookups = int(fp.get("lookups", 0))
        self.hits = int(fp.get("hits", 0))
        self.tokens_reused = int(fp.get("tokens_reused", 0))

    def match_len(self, tokens, limit=None, ns=None):
        """Longest page-aligned prefix of ``tokens[:limit]`` present
        in the shipped digest set, in tokens.  Walks shortest-first
        and stops at the first miss — the trie guarantees every
        ancestor of a cached prefix is cached too, so a missing
        k-page digest rules out every longer one.  ``ns`` must be the
        same (tenant namespace, adapter) key the serving cache used,
        or the salted digests can never match."""
        if not self._digests or not self.page_size:
            return 0
        n = len(tokens) if limit is None else min(limit, len(tokens))
        matched = 0
        for k in range(self.page_size, n + 1, self.page_size):
            if prefix_digest(tokens[:k], ns=ns) not in self._digests:
                break
            matched = k
        return matched
