"""Paged-KV page pool + radix prefix index (host-side bookkeeping).

A copy of ``ddp_tpu/serve/pages.py`` (pure host code), kept in the port
so that it imports nothing of the JAX package; ``check_invariants`` and
the property test hold the two copies to the same behaviour.

The fixed-lane ``SlotCache`` pays N full prefills and N cache copies
for N requests sharing a system prompt. The paged layout breaks that
coupling: K/V live in a pool of ``page_size``-token **pages** ([depth,
num_pages, page_size, H_kv, Dh], models/generate.PagedSlotCache) and
each decode lane maps pages through an int32 page table — so two lanes
whose prompts share a prefix can map the SAME pages copy-free, and a
completed prompt's pages stay resident as a cached prefix for future
requests.

This module is the engine's allocator + index, all host-side Python:
the device only ever sees the page-table int32 tensor the engine
uploads at bind/retire time.

- :class:`PrefixCache` — refcounted page allocator fused with a
  **page-granular radix trie** over token ids. Each trie edge is one
  full page's token tuple, so a node's path from the root spells the
  exact token prefix (and therefore the exact absolute positions)
  whose K/V its page holds — the property that makes reuse sound:
  matching the path guarantees the cached bytes are what a fresh
  prefill of those tokens would have written.
- **Refcounts** count live lane mappings. A page with refcount 0 that
  a trie node owns is *cached* (resident, evictable); one owned by no
  node returns to the free list at unmap. Invariant (pinned by the
  property test): a mapped lane maps its whole path, so a parent's
  refcount never drops below a child's — which is what makes subtree
  eviction safe.
- **LRU eviction**: allocation pressure evicts the least-recently-
  matched cached page *and its whole subtree* (a child prefix is
  unreachable without its parent). Matching touches the full path, so
  ancestors are always at least as fresh as descendants.

Page 0 is the reserved **scratch page**: idle lanes' all-zero page
tables read and write it, and writes past a lane's table end fall into
it — it is never allocated, never indexed, never attended by a live
lane (live tables never contain 0 inside a lane's demand region).
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Optional


def page_demand(
    prompt_len: int,
    max_new_tokens: int,
    page_size: int,
    *,
    total_len: int,
    reserve: int = 0,
) -> int:
    """Pages a lane must own to serve a request → ceil division.

    ``reserve`` is the speculative-decoding γ-1 write reserve (a verify
    round writes γ rows per lane, so the last round may overshoot the
    emission budget by up to γ-1 positions) — in paged mode the reserve
    is accounted in PAGES here, not just in the scheduler's token
    ceiling, so a verify-round write can never land in an unowned
    (scratch) page. The engine passes ``spec_tokens - 1`` when it
    speculates, else 0.
    """
    need = min(total_len, prompt_len + max_new_tokens + max(0, reserve))
    return -(-need // page_size)


class _Node:
    """One radix-trie node: owns one page, keyed by its page's token
    tuple under its parent."""

    __slots__ = ("key", "page_id", "parent", "children")

    def __init__(self, key, page_id, parent):
        self.key = key
        self.page_id = page_id
        self.parent = parent
        self.children: dict[tuple, "_Node"] = {}


class PrefixCache:
    """Refcounted page pool + radix prefix index over ``num_pages``
    pages of ``page_size`` tokens (page 0 reserved as scratch).

    The engine calls exactly three things: :meth:`acquire` at lane
    bind (match cached prefix pages + allocate the private remainder,
    evicting LRU cached prefixes under pressure), :meth:`release` at
    retire (publish the prompt's full pages into the index, unmap
    everything), and :meth:`stats` for the gauges. All operations are
    O(pages touched); the trie walk is O(prompt/page_size).
    """

    def __init__(self, num_pages: int, page_size: int):
        if num_pages < 2:
            raise ValueError(
                f"num_pages must be >= 2 (page 0 is the reserved "
                f"scratch page), got {num_pages}"
            )
        if page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        self.num_pages = num_pages
        self.page_size = page_size
        # Pop from the tail so pages allocate in ascending id order
        # (deterministic tables make the identity tests readable).
        self._free = list(range(num_pages - 1, 0, -1))
        self._refcount: dict[int, int] = {}
        # Evictable set: indexed pages at refcount 0, LRU-ordered
        # (oldest first — OrderedDict move_to_end on touch).
        self._cached: "OrderedDict[int, None]" = OrderedDict()
        self._node_of: dict[int, _Node] = {}
        self._root = _Node(key=None, page_id=0, parent=None)
        # Counters for the gauges (monotone; the engine exposes them).
        self.hit_requests = 0
        self.miss_requests = 0
        self.hit_tokens = 0
        self.prompt_tokens = 0
        self.evicted_pages = 0
        # Pages installed from ANOTHER replica's pool (PrefixCache
        # .adopt — the disaggregation/prefix-tier migration path);
        # 0 on every non-disaggregated engine.
        self.adopted_pages = 0

    # ---- derived state (the /statusz + /metricsz gauges) ------------

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def resident_pages(self) -> int:
        """Pages holding live K/V: mapped by a lane or cached in the
        index (everything but free + scratch)."""
        return self.num_pages - 1 - len(self._free)

    @property
    def cached_pages(self) -> int:
        return len(self._cached)

    @property
    def shared_pages(self) -> int:
        """Pages mapped by two or more lanes at once — the copy-free
        fork count."""
        return sum(1 for rc in self._refcount.values() if rc >= 2)

    @property
    def mapped_pages(self) -> int:
        """Unique pages currently mapped by at least one lane."""
        return len(self._refcount)

    @property
    def mapped_page_refs(self) -> int:
        """Σ refcounts: what the lane-copies baseline would have to
        keep resident — mapped_page_refs / mapped_pages (unique) is
        the effective-slots multiplier the engine exports."""
        return sum(self._refcount.values())

    def hit_rate(self) -> Optional[float]:
        """Token-level prefix-hit rate over all acquires, None before
        any traffic."""
        if not self.prompt_tokens:
            return None
        return self.hit_tokens / self.prompt_tokens

    # ---- internals --------------------------------------------------

    def _chunks(self, tokens) -> list[tuple]:
        ps = self.page_size
        return [
            tuple(tokens[i : i + ps])
            for i in range(0, len(tokens) - ps + 1, ps)
        ]

    def _touch(self, node: _Node) -> None:
        """Refresh LRU recency. The ordering lives ENTIRELY in the
        ``_cached`` OrderedDict (append on unmap, move_to_end here,
        evict from the front) — there is deliberately no per-node
        timestamp to drift out of sync with it."""
        if node.page_id in self._cached:
            self._cached.move_to_end(node.page_id)

    def _map(self, pid: int) -> None:
        self._refcount[pid] = self._refcount.get(pid, 0) + 1
        self._cached.pop(pid, None)  # pinned while mapped

    def _unmap(self, pid: int) -> None:
        rc = self._refcount.get(pid, 0)
        if rc <= 0:
            raise RuntimeError(f"unmap of unmapped page {pid}")
        if rc > 1:
            self._refcount[pid] = rc - 1
            return
        del self._refcount[pid]
        if pid in self._node_of:
            self._cached[pid] = None  # evictable cached prefix
        else:
            self._free.append(pid)

    def _evict_subtree(self, node: _Node) -> int:
        """Free ``node``'s page and every descendant's → pages freed.

        Sound because a lane maps its whole path: refcount(parent) >=
        refcount(child), so an evictable (refcount-0) node's subtree
        is refcount-0 throughout — asserted, never assumed.
        """
        freed = 0
        stack = [node]
        while stack:
            n = stack.pop()
            stack.extend(n.children.values())
            pid = n.page_id
            if self._refcount.get(pid, 0) > 0:  # pragma: no cover
                raise RuntimeError(
                    f"eviction reached mapped page {pid}: the "
                    "path-refcount invariant is broken"
                )
            self._cached.pop(pid, None)
            del self._node_of[pid]
            self._free.append(pid)
            freed += 1
        if node.parent is not None:
            del node.parent.children[node.key]
        self.evicted_pages += freed
        return freed

    def _alloc(self, n: int) -> Optional[list[int]]:
        """Take ``n`` free pages, evicting LRU cached prefixes as
        needed; None (nothing taken) when the pool cannot satisfy.

        The feasibility check comes FIRST: free + cached is exactly
        the attainable maximum (an evictable node's whole subtree is
        itself refcount-0 cached), so an unsatisfiable demand —
        a page-starved bind that will requeue and retry every step —
        must return None without evicting anything. Draining the
        prefix cache for an allocation that cannot succeed would
        collapse the hit rate for all other traffic while the head
        waits.
        """
        if len(self._free) + len(self._cached) < n:
            return None
        while len(self._free) < n:
            oldest = next(iter(self._cached))
            self._evict_subtree(self._node_of[oldest])
        return [self._free.pop() for _ in range(n)]

    # ---- engine surface ---------------------------------------------

    def match(self, tokens, max_pages: int) -> list[int]:
        """Longest cached prefix at page granularity → page ids
        (touches the matched path for LRU)."""
        pids: list[int] = []
        node = self._root
        for key in self._chunks(tokens)[:max_pages]:
            child = node.children.get(key)
            if child is None:
                break
            self._touch(child)
            pids.append(child.page_id)
            node = child
        return pids

    def acquire(
        self, tokens, demand_pages: int
    ) -> Optional[tuple[list[int], int]]:
        """Bind-time entry: → (page ids for the lane's table, matched
        token count), or None when the pool cannot satisfy the demand
        even after evicting every unpinned cached prefix (the caller
        requeues the request — page-based admission backpressure).

        The match is capped at ``(len(tokens) - 1) // page_size``
        pages so at least one prompt token always remains to prefill:
        the request's first output token must be sampled from a real
        forward pass (there is no cached-logits shortcut), the same
        reason vLLM never matches a whole prompt.
        """
        cap = min(max(0, (len(tokens) - 1) // self.page_size),
                  demand_pages)
        matched = self.match(tokens, cap)
        # Map matched pages BEFORE allocating: mapping pins them, so
        # the allocation's LRU eviction can never free the prefix just
        # matched.
        for pid in matched:
            self._map(pid)
        new = self._alloc(demand_pages - len(matched))
        if new is None:
            for pid in matched:  # roll back — nothing acquired
                self._unmap(pid)
            return None
        for pid in new:
            self._map(pid)
        n_hit = len(matched) * self.page_size
        self.prompt_tokens += len(tokens)
        self.hit_tokens += n_hit
        if matched:
            self.hit_requests += 1
        else:
            self.miss_requests += 1
        return matched + new, n_hit

    def adopt(
        self, tokens
    ) -> Optional[tuple[list[int], list[tuple[int, int]]]]:
        """Host an EXTERNALLY-prefilled prefix (disaggregation's
        install path; the port's engine does not call it yet): → (page ids spelling the whole prefix
        path, [(page ordinal, page id)] for the pages that are NEW
        here — the K/V bytes the caller must copy into the pool), or
        None when the pool cannot host the missing pages even after
        LRU eviction (the caller skips the install; the request just
        prefills locally).

        Only FULL pages adopt (``len(tokens) // page_size`` — the
        same publish rule as :meth:`release`). Pages already on the
        path are kept (their bytes are identical by the trie-path
        property — same tokens, same positions, same K/V) and only
        touched for LRU; the allocation pins the existing path first,
        so eviction pressure can never free the prefix being extended.
        New pages enter the index CACHED at refcount 0 — exactly the
        state :meth:`release` leaves published pages in — so the next
        local :meth:`acquire` maps them as an ordinary prefix hit.
        Adoption counts toward no hit/miss counters: it is supply,
        not demand.
        """
        keys = self._chunks(tokens)
        node = self._root
        have: list[int] = []
        for key in keys:
            child = node.children.get(key)
            if child is None:
                break
            self._touch(child)
            have.append(child.page_id)
            node = child
        missing = keys[len(have):]
        if not missing:
            return have, []
        for pid in have:  # pin the existing path across the alloc
            self._map(pid)
        new = self._alloc(len(missing))
        for pid in have:
            self._unmap(pid)
        if new is None:
            return None
        pids = list(have)
        fill: list[tuple[int, int]] = []
        for ordinal, (key, pid) in enumerate(
            zip(missing, new), start=len(have)
        ):
            child = _Node(key=key, page_id=pid, parent=node)
            node.children[key] = child
            self._node_of[pid] = child
            self._cached[pid] = None  # published, evictable
            node = child
            pids.append(pid)
            fill.append((ordinal, pid))
        self.adopted_pages += len(fill)
        return pids, fill

    def release(
        self, tokens, page_ids: list[int], prefilled_tokens: int
    ) -> None:
        """Retire-time entry: publish the prompt's fully-written pages
        into the index, then unmap every page the lane held.

        Only FULL pages of PROMPT tokens are publishable — decode
        output is request-private, and a page is only valid once every
        one of its ``page_size`` positions was actually prefilled
        (``prefilled_tokens`` caps mid-prefill evictions). A node that
        already exists keeps its page (two lanes that missed
        concurrently on the same prompt converge on the first
        publisher; the second's duplicate page simply frees at unmap).
        """
        n_pub = min(prefilled_tokens, len(tokens)) // self.page_size
        node = self._root
        for key, pid in zip(self._chunks(tokens)[:n_pub], page_ids):
            child = node.children.get(key)
            if child is None:
                if pid in self._node_of:  # pragma: no cover
                    raise RuntimeError(
                        f"page {pid} already owned by another prefix"
                    )
                child = _Node(key=key, page_id=pid, parent=node)
                node.children[key] = child
                self._node_of[pid] = child
            self._touch(child)
            node = child
        for pid in page_ids:
            self._unmap(pid)

    def stats(self) -> dict:
        hr = self.hit_rate()
        return {
            "page_size": self.page_size,
            "num_pages": self.num_pages,
            "pages_free": self.free_pages,
            "pages_resident": self.resident_pages,
            "pages_cached": self.cached_pages,
            "pages_shared": self.shared_pages,
            "prefix_hits": self.hit_requests,
            "prefix_misses": self.miss_requests,
            "prefix_hit_rate": None if hr is None else round(hr, 4),
            "evicted_pages": self.evicted_pages,
            # Absent until a migration installs pages: the stats of an
            # engine that never adopts stay as they were.
            **(
                {"adopted_pages": self.adopted_pages}
                if self.adopted_pages
                else {}
            ),
        }

    def check_invariants(self) -> None:
        """Allocator soundness (the property test's oracle): free,
        mapped and cached partition the non-scratch pool; no page is
        free while mapped; every cached page has an index node."""
        free = set(self._free)
        mapped = set(self._refcount)
        cached = set(self._cached)
        assert not (free & mapped), f"freed while mapped: {free & mapped}"
        assert not (free & cached), f"freed while cached: {free & cached}"
        assert not (mapped & cached), (
            f"cached while mapped: {mapped & cached}"
        )
        indexed = set(self._node_of)
        assert cached <= indexed, "cached page without an index node"
        assert indexed <= (mapped | cached), (
            "index node owns a freed page: "
            f"{indexed - mapped - cached}"
        )
        accounted = free | mapped | cached
        assert accounted == set(range(1, self.num_pages)), (
            f"page leak: {set(range(1, self.num_pages)) - accounted}"
        )
        assert all(rc > 0 for rc in self._refcount.values())
