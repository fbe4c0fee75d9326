"""Copy-on-write prefix cache: a trie over token-id prefixes that maps
them to physical pages of the paged KV pool.

Shared system prompts and few-shot prefixes dominate real traffic.  A
physical K/V page (and, for SLA2, its pooled router key) is a pure
function of the token ids that produced it, so two requests whose prompts
agree on their first ``k * page_size`` tokens can share the same ``k``
physical pages.  The trie keeps one node per full page, so admission can
skip the chunked prefill of the longest cached prefix.

The SLA2 linear branch's running totals (h_tot, z_tot) are not a pure
function of the page: they are per-slot state, summed chunk by chunk
during prefill.  Each chunk-aligned node therefore keeps a host snapshot
of every layer's totals as they stood right after that chunk, O(layers *
d^2) bytes, so that a hit restores the linear branch with one device
write and the resumed prefill runs bit for bit as a cold one.

The same bit-identity fixes the hit granularity: the totals are f32 sums
grouped by prefill chunk, so a hit may resume prefill only at a chunk
boundary.  ``lookup`` truncates the matched path to a multiple of
``pages_per_chunk``; the snapshots are taken at exactly those depths.

References are counted by the serving ``PageAllocator``: the cache holds
one reference per node and every slot mapping the page one more.
``evict_one`` drops the least recently used unpinned leaf under pool
pressure, and a pin protects the shared prefix of a preempted slot until
it resumes: shared pages are never swapped out or freed while referenced.
Slots never write a shared page; the engine copies it into a private page
first (``ServeEngine._cow_page``).

This module is host-only (no tensors): the snapshots it stores are
whatever the engine hands it.
"""
from __future__ import annotations

from typing import Any, Optional


class PrefixNode:
    """One trie node: one full physical page of ``page_size`` tokens.

    ``key`` is the tuple of the page's token ids, ``page`` the physical
    page the cache holds a reference to, ``depth`` the 1-based number of
    pages from the root, ``totals`` the per-layer (h_tot, z_tot) snapshot
    after this page (at chunk-aligned depths only; None for mechanisms
    without linear totals), ``pins`` the number of slots whose pages
    depend on this subtree staying alive."""

    __slots__ = ("key", "page", "parent", "children", "depth", "totals",
                 "has_totals", "pins", "last_used")

    def __init__(self, key: tuple, page: int, parent: "PrefixNode",
                 depth: int):
        self.key = key
        self.page = page
        self.parent = parent
        self.children: dict[tuple, PrefixNode] = {}
        self.depth = depth
        self.totals: Any = None
        self.has_totals = False
        self.pins = 0
        self.last_used = 0


class PrefixCache:
    """Trie over token-id prefixes at full-page granularity.

    ``page_size`` is the tokens per page (the model's block_k),
    ``pages_per_chunk`` the prefill-chunk granularity a hit aligns to,
    ``need_totals`` whether a hit needs a totals snapshot at its depth
    (True for SLA2 stacks, False for dense ones)."""

    def __init__(self, page_size: int, pages_per_chunk: int,
                 need_totals: bool):
        self.page_size = page_size
        self.pages_per_chunk = max(1, pages_per_chunk)
        self.need_totals = need_totals
        self._root = PrefixNode((), 0, None, 0)
        self._tick = 0

    def _touch(self, node: PrefixNode) -> None:
        self._tick += 1
        node.last_used = self._tick

    def _keys(self, tokens, n_pages: int):
        ps = self.page_size
        return [tuple(int(t) for t in tokens[i * ps:(i + 1) * ps])
                for i in range(n_pages)]

    def _iter_nodes(self):
        stack = list(self._root.children.values())
        while stack:
            n = stack.pop()
            yield n
            stack.extend(n.children.values())

    # -- queries --------------------------------------------------------
    def lookup(self, tokens) -> tuple[list[int], Optional[PrefixNode]]:
        """The longest usable cached prefix of ``tokens``: the trie walk
        over the prompt's full pages, truncated to the deepest
        chunk-aligned depth (with a snapshot when one is needed).  Returns
        the hit's physical page ids (maybe none) and the node at the hit
        depth, and touches the path's LRU clocks."""
        n_full = len(tokens) // self.page_size
        node, path = self._root, []
        for key in self._keys(tokens, n_full):
            child = node.children.get(key)
            if child is None:
                break
            path.append(child)
            node = child
        depth = len(path)
        while depth > 0:
            cand = path[depth - 1]
            if depth % self.pages_per_chunk == 0 and \
                    (not self.need_totals or cand.has_totals):
                break
            depth -= 1
        if depth == 0:
            return [], None
        for n in path[:depth]:
            self._touch(n)
        return [n.page for n in path[:depth]], path[depth - 1]

    def ancestor(self, node: PrefixNode, depth: int) -> PrefixNode:
        """The node at 1-based ``depth`` on the path to ``node`` (which is
        at or below that depth)."""
        while node.depth > depth:
            node = node.parent
        assert node.depth == depth, "ancestor below requested depth"
        return node

    def totals_at(self, node: PrefixNode, depth: int):
        """The totals snapshot ``depth`` pages down ``node``'s path (None
        for mechanisms without totals)."""
        n = self.ancestor(node, depth)
        assert not self.need_totals or n.has_totals, \
            "hit depth has no totals snapshot"
        return n.totals

    # -- updates --------------------------------------------------------
    def insert(self, tokens, page_row, n_pages: int, snaps: dict,
               allocator) -> tuple[int, Optional[PrefixNode]]:
        """Index a prefilled prompt's first ``n_pages`` full pages, adding
        a reference in ``allocator`` to each page that gets a new node (an
        existing node keeps its page: the submitting slot's duplicate
        stays private and is freed with the slot).  ``snaps`` maps
        chunk-aligned depths to snapshots (None for dense stacks).
        Returns (new nodes, the deepest node of the path)."""
        node, created = self._root, 0
        for i, key in enumerate(self._keys(tokens, n_pages)):
            depth = i + 1
            child = node.children.get(key)
            if child is None:
                child = PrefixNode(key, int(page_row[i]), node, depth)
                allocator.incref(child.page)
                node.children[key] = child
                created += 1
            if depth in snaps and not child.has_totals:
                child.totals = snaps[depth]
                child.has_totals = True
            self._touch(child)
            node = child
        return created, (node if node is not self._root else None)

    def pin(self, node: PrefixNode) -> None:
        """Protect ``node``, and with it its ancestors (eviction takes
        leaves only), while a slot maps its pages.  A slot keeps its pin
        for its whole life, preemption included: an evicted node's page
        would drop to refcount 0 when the slot is preempted, and could be
        handed out again before the slot resumes."""
        node.pins += 1

    def unpin(self, node: PrefixNode) -> None:
        """Release a ``pin``."""
        assert node.pins > 0
        node.pins -= 1

    def evict_one(self, allocator) -> bool:
        """Drop the least recently used unpinned leaf and its reference in
        ``allocator`` (the page reaches the free list once no slot maps
        it).  False when nothing can be evicted."""
        victim = None
        for n in self._iter_nodes():
            if n.children or n.pins:
                continue
            if victim is None or n.last_used < victim.last_used:
                victim = n
        if victim is None:
            return False
        allocator.free([victim.page])
        del victim.parent.children[victim.key]
        return True

    # -- introspection --------------------------------------------------
    @property
    def n_nodes(self) -> int:
        """Nodes (cached pages) indexed now."""
        return sum(1 for _ in self._iter_nodes())

    def page_refs(self) -> dict[int, int]:
        """Physical page -> references the cache holds (one per node)."""
        refs: dict[int, int] = {}
        for n in self._iter_nodes():
            refs[n.page] = refs.get(n.page, 0) + 1
        return refs

    def evictable_pages(self, allocator) -> int:
        """Pages that evictions could return to the free list: unpinned
        nodes whose page only the cache holds, less the ancestors of
        pinned nodes (leaf-only eviction cannot reach them while the pin
        lasts).  Admission adds this to ``allocator.available``, so that a
        pool full of cold cached prefixes still admits new work."""
        protected = set()
        for n in self._iter_nodes():
            if n.pins:
                p = n.parent
                while p is not None and id(p) not in protected:
                    protected.add(id(p))
                    p = p.parent
        return sum(1 for n in self._iter_nodes()
                   if n.pins == 0 and id(n) not in protected
                   and allocator.refcount(n.page) == 1)
