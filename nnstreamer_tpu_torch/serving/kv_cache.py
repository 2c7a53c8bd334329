"""Paged KV cache with radix-tree prefix sharing — port of
nnstreamer_tpu/serving/kv_cache.py.

The contiguous engine reserves one ``max_len`` KV region per slot, so
concurrency is capped at ``n_slots`` and every short request strands the
tail of its reservation. This module replaces the reservation with fixed-size
pages:

- **Page pool.** One device tensor pair per engine, ``(n_pages + 1, L·H,
  page_size, head_dim)`` float32, in the flat per-slot layout the step forms
  consume. Page 0 is the reserved null page: table entries past a request's
  allocation point at it, so the writes of empty or finished slots land
  somewhere never attended instead of in live pages.
- **Host-side allocator.** A FIFO free list plus per-request reservations:
  admission reserves ``ceil((T + max_new - 1) / ps)`` pages up front (less
  the prefix hits), so an allocation made for an admitted request cannot
  fail mid-chunk. Admission is gated on ``available()`` (free + evictable −
  reserved).
- **Radix prefix sharing.** A radix tree over token chunks (one node per
  full page) content-addresses K/V pages: prompts sharing a prefix share its
  device pages. A hit pins the matched path for the request's lifetime.
- **Copy-on-write.** A partial intra-page match is served by copying the
  best-matching child's page on the device and letting the suffix prefill
  overwrite from the divergence point, so writes only land in pages the
  request owns outright.
- **Deterministic LRU eviction, optional host offload.** Released nodes
  (ref 0) queue for eviction in unpin order. Without ``host_offload`` an
  evicted node and its subtree leave the tree and their pages return to the
  free list; with it, the page is copied to the host once (one blocking
  ``.cpu()``) and the node stays in the tree page-less, so a later prompt
  hitting it re-uploads (a ``copy_`` into a pool page) instead of recomputing.

Unlike the JAX package, which donates the pools through its jitted calls and
rebinds ``kpool``/``vpool`` after each, the port allocates each pool once and
writes it in place (``index_copy_``/``copy_``): the engine's CUDA graphs keep
the pools' addresses, so nothing may rebind them. Every write and read of a
pool is issued on the caller's current stream, which orders a page's writes
before the next program that reads it. The free list, LRU order and
``stats`` are the JAX module's, so the same workload gets the same page ids
in both packages. The pool gauges, the hit/evict/offload/re-upload counters
(``nnstpu_serving_kv_*``) and the ``serving.kv_offload``/``kv_reupload``
events are the JAX module's too; the gauges read the host-side allocator
(free list, shared count), never a pool on the card.
"""

from __future__ import annotations

import hashlib
from collections import OrderedDict, deque
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Set, Tuple

import numpy as np
import torch

from ..core.hw import resolve_device
from ..obs import events as _events
from ..obs import metrics as _obs

__all__ = ["PagedKVCache", "PageNode", "AdmitPlan", "PageLease",
           "PAGE_DOC_VERSION", "empty_page_pool", "prompt_path_hashes"]

#: page-transfer document schema version; import_pages rejects newer majors
PAGE_DOC_VERSION = 1


def _chain_hash(prev: bytes, key: Any) -> "hashlib.blake2b":
    """One link of the chained per-chunk path hash: a digest over the parent
    chunk's digest and this chunk's token ids, so membership of hashes[i]
    implies the whole path 0..i matches."""
    h = hashlib.blake2b(digest_size=8)
    h.update(prev)
    h.update(np.asarray(key, np.int32).tobytes())
    return h


def prompt_path_hashes(tokens: Any, page_size: int) -> List[str]:
    """Chained hashes of a prompt's full-page chunks, root first: the key
    list a prefix-aware router matches against
    :meth:`PagedKVCache.prefix_digest`."""
    toks = np.asarray(tokens, np.int32).reshape(-1)
    out: List[str] = []
    prev = b""
    for k in range(int(toks.size) // page_size):
        h = _chain_hash(prev, toks[k * page_size:(k + 1) * page_size])
        prev = h.digest()
        out.append(h.hexdigest())
    return out


def empty_page_pool(n_pages: int, n_layers: int, n_heads: int,
                    page_size: int, head_dim: int, device: Any = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Zero K/V page pools, ``(n_pages + 1, L·H, page_size, head_dim)``
    float32 on ``device`` (cuda unless the caller names the CPU). The +1 is
    the null page (id 0); usable pages are 1..n_pages. A gathered run of
    pages is a contiguous cache view (models/causal_lm.paged_view_slots)."""
    dev = resolve_device(device)
    shape = (n_pages + 1, n_layers * n_heads, page_size, head_dim)
    return (torch.zeros(shape, dtype=torch.float32, device=dev),
            torch.zeros(shape, dtype=torch.float32, device=dev))


def _dtype_name(dtype: torch.dtype) -> str:
    """A pool dtype as the JAX package writes it (``"float32"``, not
    ``"torch.float32"``), so the two packages' page documents interchange."""
    return str(dtype).replace("torch.", "")


class PageNode:
    """One radix-tree node = one full page of tokens. ``key`` is the page's
    token tuple; ``page`` its device page id (None when evicted, with a host
    copy in ``host_kv`` under offload); ``ref`` the pin count (active
    requests whose table uses this page)."""

    __slots__ = ("key", "parent", "children", "page", "host_kv", "ref")

    def __init__(self, key: Optional[tuple], parent: "PageNode | None",
                 page: Optional[int]) -> None:
        self.key = key
        self.parent = parent
        self.children: Dict[tuple, PageNode] = {}
        self.page = page
        self.host_kv: Optional[Tuple[np.ndarray, np.ndarray]] = None
        self.ref = 0


@dataclass
class AdmitPlan:
    """A pure lookup result: nothing is pinned or allocated until
    :meth:`PagedKVCache.admit` commits it. ``nodes`` is the matched radix
    path (full-page hits, on the device or offloaded); ``cow`` an optional
    (node, m) partial intra-page match served by copy-on-write. The engine
    may ``drop_tail()`` to shrink the hit until the padded suffix window
    fits the slot view."""

    tokens: np.ndarray
    page_size: int
    nodes: List[PageNode]
    cow: Optional[Tuple[PageNode, int]]

    @property
    def hit_len(self) -> int:
        m = self.cow[1] if self.cow is not None else 0
        return len(self.nodes) * self.page_size + m

    def drop_tail(self) -> None:
        """Shrink the hit by one unit: the COW tail first, then the deepest
        matched node (lookup order reversed, so trimming is deterministic)."""
        if self.cow is not None:
            self.cow = None
        elif self.nodes:
            self.nodes.pop()


@dataclass
class PageLease:
    """One admitted request's page bookkeeping. ``pages`` is the table row
    (chunk order); ``own`` the subset owned outright (freed or registered at
    release); ``nodes`` the pinned tree nodes (unpinned at release);
    ``reserved`` the pages still claimable from the reservation."""

    hit_len: int
    pages: List[int] = field(default_factory=list)
    own: Set[int] = field(default_factory=set)
    nodes: List[PageNode] = field(default_factory=list)
    reserved: int = 0


class PagedKVCache:
    """Device page pools + host allocator + radix prefix index.

    The engine owns the scheduling; this class owns every page-lifetime
    decision. ``kpool``/``vpool`` are allocated once on ``device`` (cuda
    unless the caller names the CPU) and only ever written in place.
    """

    def __init__(self, n_layers: int, n_heads: int, page_size: int,
                 n_pages: int, head_dim: int, *,
                 host_offload: bool = False, device: Any = None,
                 label: str = "lm") -> None:
        if page_size < 1 or n_pages < 1:
            raise ValueError("page_size and n_pages must be >= 1")
        self.page_size = page_size
        self.n_pages = n_pages
        self.host_offload = host_offload
        self.kpool, self.vpool = empty_page_pool(
            n_pages, n_layers, n_heads, page_size, head_dim, device)
        self.free: deque[int] = deque(range(1, n_pages + 1))
        self.reserved = 0
        self.root = PageNode(None, None, None)
        #: ref-0 device-paged nodes in unpin order: the eviction queue
        self._lru: "OrderedDict[PageNode, int]" = OrderedDict()
        self._lru_seq = 0
        self._shared = 0  # nodes pinned by >= 2 requests
        self.stats = {"lookups": 0, "hit_requests": 0, "hit_tokens": 0,
                      "prompt_tokens": 0, "cow_copies": 0, "evictions": 0,
                      "offloads": 0, "reuploads": 0, "pages_peak": 0,
                      "exported_pages": 0, "imported_pages": 0,
                      "spilled_pages": 0}
        self._label = label
        self._init_metrics(label)

    def _init_metrics(self, label: str) -> None:
        """serving.kv_* families (the JAX module's names, and the naming
        lint's kv placement rule). Gauges read through a weakref so holding
        the registry never pins a retired engine's pools, and read host
        state only, so a scrape never touches the card."""
        import weakref

        reg = _obs.registry()
        ref = weakref.ref(self)
        reg.gauge(
            "nnstpu_serving_kv_total_pages",
            "KV page-pool capacity (excludes the null page)",
            ("engine",)).labels(label).set_function(
                lambda: ref().n_pages if ref() is not None else 0)
        reg.gauge(
            "nnstpu_serving_kv_used_pages",
            "KV pages currently allocated (shared + private)",
            ("engine",)).labels(label).set_function(
                lambda: ref().used_pages() if ref() is not None else 0)
        reg.gauge(
            "nnstpu_serving_kv_shared_pages",
            "Prefix pages pinned by two or more live requests",
            ("engine",)).labels(label).set_function(
                lambda: ref().shared_pages() if ref() is not None else 0)
        self._m_hit = reg.counter(
            "nnstpu_serving_kv_prefix_hit_total",
            "Prompt tokens served from shared prefix pages (skipped "
            "prefill work)", ("engine",)).labels(label)
        self._m_evict = reg.counter(
            "nnstpu_serving_kv_evict_total",
            "KV pages evicted from the pool (deterministic LRU)",
            ("engine",)).labels(label)
        self._m_offload = reg.counter(
            "nnstpu_serving_kv_offload_total",
            "Cold KV pages copied to host RAM at eviction",
            ("engine",)).labels(label)
        self._m_reupload = reg.counter(
            "nnstpu_serving_kv_reupload_total",
            "Offloaded KV pages uploaded back on a later prefix hit",
            ("engine",)).labels(label)

    # -- accounting -------------------------------------------------------- #

    def used_pages(self) -> int:
        return self.n_pages - len(self.free)

    def shared_pages(self) -> int:
        return self._shared

    def available(self) -> int:
        """Pages an admission may still claim: free + evictable minus the
        reservations already promised to admitted requests."""
        return len(self.free) + len(self._lru) - self.reserved

    # -- lookup / admit / release ------------------------------------------ #

    def lookup(self, prompt: Any) -> AdmitPlan:
        """Pure radix match (no pinning, no allocation): the longest
        full-page path with device or offloaded K/V, plus the best partial
        intra-page COW candidate below it. The hit is capped at ``T - 1``
        tokens: one prompt token must remain for the suffix prefill to give
        the first-token logits."""
        self.stats["lookups"] += 1
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        t = int(prompt.size)
        self.stats["prompt_tokens"] += t
        ps = self.page_size
        node, nodes = self.root, []
        for k in range(max(0, (t - 1) // ps)):
            key = tuple(int(x) for x in prompt[k * ps:(k + 1) * ps])
            child = node.children.get(key)
            if child is None or (child.page is None
                                 and child.host_kv is None):
                break
            nodes.append(child)
            node = child
        cow = None
        rest = prompt[len(nodes) * ps:]
        cap_m = t - 1 - len(nodes) * ps
        if cap_m > 0:
            best = 0
            # children iterate in insertion order: ties resolve to the
            # earliest-registered page
            for key, child in node.children.items():
                if child.page is None:
                    continue  # COW copies from device-resident pages only
                lim = min(len(key), cap_m)
                m = 0
                while m < lim and key[m] == int(rest[m]):
                    m += 1
                if m > best:
                    best, cow = m, (child, m)
        return AdmitPlan(tokens=prompt, page_size=ps, nodes=nodes, cow=cow)

    def admissible(self, plan: AdmitPlan, b_needed: int) -> bool:
        """Can this plan be committed now? ``b_needed`` is the request's page
        budget ceil((T + max_new - 1) / ps). Counts the fresh pages needed
        (budget minus device-resident hits) plus the ref-0 matched nodes
        admission would pull out of the eviction queue."""
        d = sum(1 for nd in plan.nodes if nd.page is not None)
        pins = sum(1 for nd in plan.nodes
                   if nd.ref == 0 and nd.page is not None)
        if plan.cow is not None and plan.cow[0].ref == 0:
            pins += 1
        return self.available() >= (b_needed - d) + pins

    def admit(self, plan: AdmitPlan, b_needed: int) -> PageLease:
        """Commit a plan: pin the matched path, re-upload offloaded pages,
        COW-copy the partial match, allocate private prompt pages, and
        register the prompt's remaining full chunks as pinned nodes (so a
        request admitted one iteration later shares them). The caller has
        checked :meth:`admissible`."""
        ps = self.page_size
        prompt = plan.tokens
        t = int(prompt.size)
        d = sum(1 for nd in plan.nodes if nd.page is not None)
        reserve_n = b_needed - d
        self.reserved += reserve_n
        lease = PageLease(hit_len=plan.hit_len, reserved=reserve_n)
        for nd in plan.nodes:
            self._pin(nd)
            lease.nodes.append(nd)
        cow_src = None
        if plan.cow is not None:
            cow_src = plan.cow[0]
            # keep the source resident while allocation may evict
            self._pin(cow_src)
        try:
            for nd in plan.nodes:
                if nd.page is None:
                    self._upload(nd, self._lease_alloc(lease))
            lease.pages = [nd.page for nd in plan.nodes]
            if cow_src is not None:
                pid = self._lease_alloc(lease)
                self._copy_page(pid, cow_src.page)
                lease.pages.append(pid)
                lease.own.add(pid)
                self.stats["cow_copies"] += 1
        finally:
            if cow_src is not None:
                self._unpin(cow_src)
        while len(lease.pages) < -(-t // ps):
            pid = self._lease_alloc(lease)
            lease.pages.append(pid)
            lease.own.add(pid)
        # full prompt chunks beyond the hit become pinned tree nodes now:
        # their content is valid once the admission prefill's writes land,
        # which the one stream orders before any later reader
        self._register(lease, prompt, t // ps, pin=True)
        if plan.hit_len:
            self.stats["hit_requests"] += 1
            self.stats["hit_tokens"] += plan.hit_len
            self._m_hit.inc(plan.hit_len)
        return lease

    def lease_alloc(self, lease: PageLease) -> int:
        """Allocate one decode page against the lease's reservation (cannot
        fail: the reservation was gated at admission) and return its id; the
        caller owns the table write."""
        pid = self._lease_alloc(lease)
        lease.pages.append(pid)
        lease.own.add(pid)
        return pid

    def release(self, lease: PageLease, seq: np.ndarray) -> None:
        """Retire a request: register the generated full pages (``seq`` =
        prompt + consumed output tokens, the positions with valid K/V) at
        ref 0, unpin the matched or created path, free the rest, and return
        the unused reservation."""
        full = min(int(np.asarray(seq).size) // self.page_size,
                   len(lease.pages))
        self._register(lease, np.asarray(seq, np.int32), full, pin=False)
        for nd in lease.nodes:
            self._unpin(nd)
        lease.nodes = []
        for pid in lease.pages:
            if pid in lease.own:
                self.free.append(pid)
        lease.own.clear()
        self.reserved -= lease.reserved
        lease.reserved = 0

    # -- page migration ---------------------------------------------------- #

    def prefix_hit_rate(self) -> float:
        """Fraction of prompt tokens served from shared prefix pages."""
        return self.stats["hit_tokens"] / max(1, self.stats["prompt_tokens"])

    def prefix_digest(self, max_entries: int = 64) -> List[str]:
        """Bounded list of chained path hashes for every contentful radix
        node, breadth first (shallow prefixes survive the bound);
        :func:`prompt_path_hashes` builds the matching client-side keys."""
        out: List[str] = []
        queue: deque = deque((child, b"")
                             for child in self.root.children.values())
        while queue and len(out) < max_entries:
            nd, prev = queue.popleft()
            if nd.page is None and nd.host_kv is None:
                continue
            h = _chain_hash(prev, nd.key)
            out.append(h.hexdigest())
            queue.extend((c, h.digest()) for c in nd.children.values())
        return out

    def _header(self) -> Dict[str, Any]:
        _, lh, ps, hd = self.kpool.shape
        return {"v": PAGE_DOC_VERSION, "page_size": ps, "lh": lh,
                "hd": hd, "dtype": _dtype_name(self.kpool.dtype)}

    def _export_doc(self, path: List[PageNode]) -> Optional[Dict[str, Any]]:
        # one gather and one copy to the host for every device-resident
        # page of the path, not two copies per page
        fetched: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}
        dev = [(i, nd.page) for i, nd in enumerate(path)
               if nd.page is not None]
        if dev:
            raw = np.asarray([p for _, p in dev], np.int64)
            # padded to the next power of two (repeating valid ids), so the
            # gather sees one shape per bucket, not one per path length
            cap = 1 << max(0, int(raw.size) - 1).bit_length()
            idx = torch.from_numpy(np.resize(raw, cap)).to(
                self.kpool.device)
            ks = self.kpool.index_select(0, idx).cpu().numpy()
            vs = self.vpool.index_select(0, idx).cpu().numpy()
            for (i, _), k, v in zip(dev, ks[:raw.size], vs[:raw.size]):
                fetched[i] = (k, v)
        entries = []
        for i, nd in enumerate(path):
            kv = fetched.get(i) or nd.host_kv
            if kv is None:
                return None  # a content-less link breaks the chain
            entries.append({"key": [int(x) for x in nd.key],
                            "k": kv[0], "v": kv[1]})
        if not entries:
            return None
        self.stats["exported_pages"] += len(entries)
        doc = self._header()
        doc["entries"] = entries
        return doc

    def export_pages(self, seq: Any) -> Optional[Dict[str, Any]]:
        """Export the registered radix path covering ``seq``'s full-page
        chunks as a transfer document (header + root-first entries of token
        keys and K/V page bits). Read-only. None when no full chunk of
        ``seq`` is in the tree."""
        seq = np.asarray(seq, np.int32).reshape(-1)
        ps = self.page_size
        node, path = self.root, []
        for k in range(int(seq.size) // ps):
            key = tuple(int(x) for x in seq[k * ps:(k + 1) * ps])
            child = node.children.get(key)
            if child is None or (child.page is None
                                 and child.host_kv is None):
                break
            path.append(child)
            node = child
        return self._export_doc(path) if path else None

    def export_path(self, nd: PageNode) -> Optional[Dict[str, Any]]:
        """Export the root-to-``nd`` path (chunk keys are position-dependent,
        so a leaf only transfers together with its ancestors)."""
        path: List[PageNode] = []
        cur: Optional[PageNode] = nd
        while cur is not None and cur.key is not None:
            path.append(cur)
            cur = cur.parent
        path.reverse()
        return self._export_doc(path) if path else None

    def import_pages(self, doc: Dict[str, Any]) -> int:
        """Splice a transfer document into this pool's radix tree and return
        the number of pages uploaded. All or nothing: a geometry mismatch
        raises ValueError and pool exhaustion RuntimeError before any tree
        or pool mutation.

        Entries whose chunk path already has content here are skipped (same
        path, same bits); the imported path is pinned root to leaf during
        the splice so its allocations cannot evict its own ancestors, then
        unpinned, so fresh nodes land ref 0 in the LRU like locally released
        prefix state."""
        if not isinstance(doc, dict):
            raise ValueError("page transfer document must be a dict")
        hdr = self._header()
        if int(doc.get("v", 0)) > PAGE_DOC_VERSION:
            raise ValueError(
                f"page transfer doc v{doc.get('v')} newer than "
                f"supported v{PAGE_DOC_VERSION}")
        for fld in ("page_size", "lh", "hd", "dtype"):
            if doc.get(fld) != hdr[fld]:
                raise ValueError(
                    f"page geometry mismatch on {fld!r}: transfer has "
                    f"{doc.get(fld)!r}, this pool has {hdr[fld]!r}")
        entries = doc.get("entries") or []
        shape = (hdr["lh"], hdr["page_size"], hdr["hd"])
        for ent in entries:
            key = ent.get("key")
            if not isinstance(key, (list, tuple)) \
                    or len(key) != self.page_size:
                raise ValueError("transfer entry key is not one full page")
            for side in ("k", "v"):
                arr = np.asarray(ent[side])
                if arr.shape != shape:
                    raise ValueError(
                        f"transfer entry {side!r} payload shape "
                        f"{arr.shape} != page shape {shape}")
        # pass 1: pin the already-contentful prefix of the path so the
        # pass-2 allocations (which may evict) can never drop it
        node, idx, pinned = self.root, 0, []
        for ent in entries:
            child = node.children.get(tuple(int(x) for x in ent["key"]))
            if child is None or (child.page is None
                                 and child.host_kv is None):
                break
            self._pin(child)
            pinned.append(child)
            node, idx = child, idx + 1
        needed = len(entries) - idx
        if needed > self.available():
            for nd in reversed(pinned):
                self._unpin(nd)
            raise RuntimeError(
                f"page transfer needs {needed} pages but only "
                f"{self.available()} are claimable — import rejected")
        # pass 2: splice; every entry past the matched prefix uploads into a
        # freshly allocated page under a node pinned on creation
        spliced = 0
        try:
            for ent in entries[idx:]:
                key = tuple(int(x) for x in ent["key"])
                child = node.children.get(key)
                if child is None:
                    child = PageNode(key, node, None)
                    node.children[key] = child
                self._pin(child)
                pinned.append(child)
                if child.page is None and child.host_kv is None:
                    pid = self._alloc()
                    self._pool_set(pid, ent["k"], ent["v"])
                    child.page = pid
                    spliced += 1
                node = child
        finally:
            for nd in reversed(pinned):
                self._unpin(nd)
        self.stats["imported_pages"] += spliced
        return spliced

    # -- cross-backend spill ----------------------------------------------- #

    def coldest(self, n: int) -> List[PageNode]:
        """Up to ``n`` coldest shed-able nodes: ref-0 LRU entries with no
        children, whose content transfers completely as one root-to-node
        path document."""
        out = []
        for nd in self._lru:
            if not nd.children:
                out.append(nd)
                if len(out) >= n:
                    break
        return out

    def shed(self, nd: PageNode) -> int:
        """Drop a cold subtree whose content was transferred elsewhere;
        returns the pages freed. Only for ref-0 nodes (from :meth:`coldest`);
        counted as spills, not evictions."""
        if nd.ref != 0:
            raise RuntimeError("shed() on a pinned node — spill policy "
                               "must only shed ref-0 LRU entries")
        self._lru.pop(nd, None)
        freed = self._drop_subtree(nd)
        self.stats["spilled_pages"] += freed
        return freed

    # -- internals --------------------------------------------------------- #

    def _register(self, lease: PageLease, seq: np.ndarray, upto: int,
                  pin: bool) -> None:
        """Walk or extend the radix path for ``seq``'s first ``upto`` full
        chunks, donating the lease's owned pages to new nodes. An existing
        node with a device page wins (our duplicate stays owned and is freed
        at release); an offloaded node adopts our page (same chunk path,
        same bits)."""
        node = self.root
        ps = self.page_size
        for k in range(upto):
            key = tuple(int(x) for x in seq[k * ps:(k + 1) * ps])
            pid = lease.pages[k]
            child = node.children.get(key)
            if child is not None:
                if child.page is None and pid in lease.own:
                    child.page = pid
                    lease.own.discard(pid)
                    if pin:
                        self._pin(child)
                        lease.nodes.append(child)
                    else:
                        self._lru_push(child)
                node = child
                continue
            if pid not in lease.own:
                # a shared page under an unregistered chunk: the matched
                # path always covers shared pages, so stop
                break
            child = PageNode(key, node, pid)
            node.children[key] = child
            lease.own.discard(pid)
            if pin:
                self._pin(child)
                lease.nodes.append(child)
            else:
                self._lru_push(child)
            node = child

    def _pin(self, nd: PageNode) -> None:
        if nd.ref == 0:
            self._lru.pop(nd, None)
        nd.ref += 1
        if nd.ref == 2:
            self._shared += 1

    def _unpin(self, nd: PageNode) -> None:
        nd.ref -= 1
        if nd.ref == 1:
            self._shared -= 1
        if nd.ref == 0 and nd.page is not None:
            self._lru_push(nd)

    def _lru_push(self, nd: PageNode) -> None:
        self._lru_seq += 1
        self._lru[nd] = self._lru_seq

    def _lease_alloc(self, lease: PageLease) -> int:
        if lease.reserved <= 0:
            raise RuntimeError(
                "KV page allocation outside the request's reservation — "
                "scheduler accounting bug")
        lease.reserved -= 1
        self.reserved -= 1
        return self._alloc()

    def _alloc(self) -> int:
        while not self.free and self._lru:
            self._evict_one()
        if not self.free:
            raise RuntimeError(
                "KV page pool exhausted despite reservation — "
                "allocator accounting bug")
        pid = self.free.popleft()
        used = self.used_pages()
        if used > self.stats["pages_peak"]:
            self.stats["pages_peak"] = used
        return pid

    def _evict_one(self) -> None:
        """Evict the least-recently-unpinned ref-0 node. Deterministic: the
        queue orders by unpin sequence and the free list is FIFO, so equal
        workloads evict (and reuse) equal pages."""
        nd = next(iter(self._lru))
        del self._lru[nd]
        if self.host_offload:
            if nd.host_kv is None:
                # one blocking copy to the host per cold page, kept for
                # every later re-upload (content is immutable once
                # registered); copy=True: on a CPU pool ``.cpu()`` would
                # return the page's own memory, which later writes change
                nd.host_kv = tuple(pool[nd.page].to("cpu", copy=True).numpy()
                                   for pool in (self.kpool, self.vpool))
                self.stats["offloads"] += 1
                self._m_offload.inc()
                _events.record(
                    "serving.kv_offload",
                    f"{self._label}: page {nd.page} offloaded to host RAM",
                    severity="debug", engine=self._label, page=nd.page)
            self.free.append(nd.page)
            nd.page = None
            self.stats["evictions"] += 1
            self._m_evict.inc()
        else:
            freed = self._drop_subtree(nd)
            self.stats["evictions"] += freed
            self._m_evict.inc(freed)

    def _drop_subtree(self, nd: PageNode) -> int:
        """Remove ``nd`` and its subtree from the tree, freeing every device
        page. Safe for unpinned nodes only: a pinned descendant would pin
        the whole path, ``nd`` included."""
        if nd.parent is not None:
            nd.parent.children.pop(nd.key, None)
        freed, stack = 0, [nd]
        while stack:
            n = stack.pop()
            stack.extend(n.children.values())
            n.children.clear()
            self._lru.pop(n, None)
            if n.page is not None:
                self.free.append(n.page)
                n.page = None
                freed += 1
            n.parent = None
        return freed

    def _pool_set(self, pid: int, k: np.ndarray, v: np.ndarray) -> None:
        """Write one page's K/V from host arrays (a document's may be
        read-only) into the pools, in place."""
        self.kpool[pid].copy_(torch.from_numpy(np.array(k, np.float32)))
        self.vpool[pid].copy_(torch.from_numpy(np.array(v, np.float32)))

    def _upload(self, nd: PageNode, pid: int) -> None:
        self._pool_set(pid, *nd.host_kv)
        nd.page = pid  # host_kv kept: later evictions skip the copy down
        self.stats["reuploads"] += 1
        self._m_reupload.inc()
        _events.record(
            "serving.kv_reupload",
            f"{self._label}: offloaded chunk re-uploaded into page {pid}",
            severity="debug", engine=self._label, page=pid)

    def _copy_page(self, dst: int, src: int) -> None:
        # the COW primitive: one on-device page copy, no host round trip
        self.kpool[dst].copy_(self.kpool[src])
        self.vpool[dst].copy_(self.vpool[src])
