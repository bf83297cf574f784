"""Device-memory arena: the paper's VMA machinery made perf-critical on TPU.

On TPU there is no host kernel to crash, but the *same* allocation-direction
property decides how many **non-contiguous DMA descriptors** a paged
KV-cache gather needs: a sequence whose logical pages land on contiguous
backing offsets can be fetched HBM→VMEM in one long DMA; a fragmented
sequence needs one descriptor per run.  :class:`DeviceArena` reuses
:class:`~repro.core.mm.MemoryManager` (with the legacy or modern
:class:`~repro.core.mm.MMConfig`) to back a page pool, and
:class:`PagedKVAllocator` exposes the page tables consumed by
``repro.kernels.paged_attention``.

Fragment statistics from here feed ``benchmarks/vma_bench.py`` and the
§Perf iteration on the decode cells.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from .mm import MemoryManager, MMConfig
from .vma import AddrRange

__all__ = ["DeviceArena", "PagedKVAllocator", "PrefixIndex", "SequencePages"]


class DeviceArena:
    """Page-granular arena over a MemoryManager-backed store."""

    def __init__(self, config: MMConfig, page_bytes: int = 64 * 1024) -> None:
        if page_bytes % config.granule and config.granule % page_bytes:
            raise ValueError("page_bytes must align with the MM granule")
        self.mm = MemoryManager(config)
        self.page_bytes = page_bytes
        self._regions: Dict[str, AddrRange] = {}
        self._lengths: Dict[str, int] = {}  # touched bytes per region

    # -- region (one per logical buffer / sequence) ------------------------

    def create_region(self, name: str, capacity_bytes: int) -> None:
        if name in self._regions:
            raise ValueError(f"region {name!r} exists")
        self._regions[name] = self.mm.mmap(capacity_bytes)
        self._lengths[name] = 0

    def destroy_region(self, name: str) -> None:
        ar = self._regions.pop(name)
        self._lengths.pop(name)
        self.mm.munmap(ar)

    def rename_region(self, old: str, new: str) -> None:
        """Re-key a region without touching its mappings.

        Used to retire a dropped sequence's region under a unique zombie
        name while other sequences still map pages it faulted — request
        ids recycle, so the original name must be free for re-use.
        """
        if new in self._regions:
            raise ValueError(f"region {new!r} exists")
        if old not in self._regions:
            raise KeyError(old)
        self._regions[new] = self._regions.pop(old)
        self._lengths[new] = self._lengths.pop(old)

    def grow(self, name: str, nbytes: int) -> None:
        """Touch (fault in) the next ``nbytes`` of the region."""
        ar = self._regions[name]
        off = self._lengths[name]
        if off + nbytes > ar.length:
            raise MemoryError(f"region {name!r} capacity exceeded")
        self.mm.touch(ar.start + off, nbytes)
        self._lengths[name] = off + nbytes

    # -- physical view ------------------------------------------------------

    def physical_pages(self, name: str) -> np.ndarray:
        """Physical page index for each faulted logical page of ``name``."""
        ar = self._regions[name]
        pages = []
        n_pages = self._lengths[name] // self.page_bytes
        for i in range(n_pages):
            addr = ar.start + i * self.page_bytes
            m = self.mm._mappings.get(self.mm._align_down(addr))
            if m is None:
                break
            delta = addr - m.addr.start
            pages.append((m.offset + delta) // self.page_bytes)
        return np.asarray(pages, dtype=np.int32)

    def contiguous_runs(self, name: str) -> int:
        """Number of contiguous physical runs = DMA descriptors needed."""
        pages = self.physical_pages(name)
        if pages.size == 0:
            return 0
        return int(1 + np.count_nonzero(np.diff(pages) != 1))

    def fragmentation_report(self) -> Dict[str, int]:
        return {
            name: self.contiguous_runs(name)
            for name in self._regions
            if self._lengths[name]
        }


@dataclass
class SequencePages:
    seq_id: str
    num_tokens: int
    pages: np.ndarray  # physical page indices, int32


def _common_len(a: Sequence[int], b: Sequence[int]) -> int:
    n = 0
    for x, y in zip(a, b):
        if x != y:
            break
        n += 1
    return n


class _PrefixNode:
    __slots__ = ("children", "seqs", "tails")

    def __init__(self) -> None:
        # edge label -> child; every edge is exactly one page worth of
        # tokens, so a tree path is a page-aligned token prefix
        self.children: Dict[Tuple[int, ...], "_PrefixNode"] = {}
        # sequences whose registered stream passes through this node
        self.seqs: Set[str] = set()
        # per-sequence sub-page remainder past this node's path
        self.tails: Dict[str, Tuple[int, ...]] = {}


class PrefixIndex:
    """Page-granular radix index over registered prompt token streams.

    Each edge spans exactly ``tokens_per_page`` tokens, so walking the
    tree yields the longest *page-aligned* prefix of a new prompt that
    some registered sequence already holds; a final token-level scan of
    the deepest node's edges and tails extends the match into a partial
    page.  Lookup takes an ``eligible`` predicate so the allocator can
    exclude poisoned/collided donors without the index knowing why.
    """

    def __init__(self, tokens_per_page: int) -> None:
        self.tokens_per_page = tokens_per_page
        self._root = _PrefixNode()
        self._paths: Dict[str, Tuple[Tuple[int, ...], ...]] = {}

    def __contains__(self, seq_id: str) -> bool:
        return seq_id in self._paths

    def insert(self, seq_id: str, tokens: Sequence[int]) -> None:
        toks = tuple(int(t) for t in tokens)
        if seq_id in self._paths:
            self.remove(seq_id)
        page = self.tokens_per_page
        full = len(toks) - len(toks) % page
        chunks = tuple(toks[i:i + page] for i in range(0, full, page))
        node = self._root
        for chunk in chunks:
            node = node.children.setdefault(chunk, _PrefixNode())
            node.seqs.add(seq_id)
        tail = toks[full:]
        if tail:
            node.tails[seq_id] = tail
        self._paths[seq_id] = chunks

    def remove(self, seq_id: str) -> None:
        chunks = self._paths.pop(seq_id, None)
        if chunks is None:
            return
        node = self._root
        path = [node]
        for chunk in chunks:
            node = node.children[chunk]
            node.seqs.discard(seq_id)
            path.append(node)
        node.tails.pop(seq_id, None)
        for i in range(len(path) - 1, 0, -1):
            n = path[i]
            if n.seqs or n.tails or n.children:
                break
            del path[i - 1].children[chunks[i - 1]]

    def rename(self, old: str, new: str) -> None:
        chunks = self._paths.pop(old, None)
        if chunks is None:
            return
        node = self._root
        for chunk in chunks:
            node = node.children[chunk]
            node.seqs.discard(old)
            node.seqs.add(new)
        if old in node.tails:
            node.tails[new] = node.tails.pop(old)
        self._paths[new] = chunks

    def lookup(
        self, tokens: Sequence[int], eligible
    ) -> Tuple[Optional[str], int]:
        """``(donor, matched_tokens)`` for the longest eligible prefix.

        The donor's registered stream covers *all* matched tokens, not
        just the last page — sequences are recorded on every node along
        their path.  Returns ``(None, 0)`` when nothing matches.
        """
        toks = tuple(int(t) for t in tokens)
        page = self.tokens_per_page
        node, donor, matched = self._root, None, 0
        rest = toks
        while len(rest) >= page:
            child = node.children.get(rest[:page])
            if child is None:
                break
            cands = sorted(s for s in child.seqs if eligible(s))
            if not cands:
                break
            node, donor, matched = child, cands[0], matched + page
            rest = rest[page:]
        # token-level extension into the deepest partially-matching edge
        # or tail: sorted iteration keeps the donor choice deterministic
        best_ext, best_donor = 0, None
        for chunk in sorted(node.children):
            ext = _common_len(chunk, rest)
            if ext <= best_ext:
                continue
            cands = sorted(
                s for s in node.children[chunk].seqs if eligible(s)
            )
            if cands:
                best_ext, best_donor = ext, cands[0]
        for s in sorted(node.tails):
            if not eligible(s):
                continue
            ext = _common_len(node.tails[s], rest)
            if ext > best_ext:
                best_ext, best_donor = ext, s
        if best_ext:
            return best_donor, matched + best_ext
        return donor, matched


class PagedKVAllocator:
    """Paged KV-cache allocator for the serving path.

    One page holds ``tokens_per_page`` tokens of one layer-group's K+V.
    Sequences grow token-by-token; pages are faulted from the arena on
    demand.  ``page_table(max_pages)`` emits the dense [num_seqs, max_pages]
    int32 table the paged-attention kernel consumes (padded with -1).
    """

    def __init__(
        self,
        config: MMConfig,
        *,
        tokens_per_page: int,
        token_bytes: int,
        max_seq_pages: int = 4096,
        pool_pages: Optional[int] = None,
    ) -> None:
        import dataclasses

        self.tokens_per_page = tokens_per_page
        page_bytes = tokens_per_page * token_bytes
        # round page size up to the MM granule so one page == >=1 granule
        page_bytes = max(page_bytes, config.granule)
        page_bytes = (page_bytes + config.granule - 1) // config.granule * config.granule
        if pool_pages is not None:
            # bound the backing store to the physical page pool so page
            # ids are dense slots in [0, pool_pages) — the paged-attention
            # kernel's K/V pool arrays are sized by this
            config = dataclasses.replace(
                config, backing_size=pool_pages * page_bytes
            )
        self.pool_pages = pool_pages
        self.arena = DeviceArena(config, page_bytes=page_bytes)
        self.max_seq_pages = max_seq_pages
        self._tokens: Dict[str, int] = {}
        self._poisoned: Set[str] = set()
        # incremental page-ownership tracking: each newly faulted page is
        # checked against the mapper table once, at fault time, so the
        # per-step validate() poll is O(1) instead of O(seqs x pages)
        self._owner: Dict[int, str] = {}      # canonical owner record
        self._mappers: Dict[int, Set[str]] = {}   # page -> mapping seqs
        self._seq_pages: Dict[str, List[int]] = {}  # logical -> physical
        self._own_pages: Dict[str, List[int]] = {}  # faulted from own region
        self._page_home: Dict[int, str] = {}  # page -> backing region name
        self._collisions: Set[str] = set()
        self._collided: Set[int] = set()      # pages with >1 backing claim
        # regions of dropped sequences kept alive because other sequences
        # still map pages they faulted; destroyed when the last page dies
        self._zombies: Dict[str, Set[int]] = {}
        self._zombie_seq = 0
        # page ledger: every page fault / release crosses these counters,
        # so allocated - freed == pages live right now (zero after drain).
        # share_prefix adds mappers without faulting, so it moves neither
        # counter; a page is freed when its last mapper unmaps.
        self.pages_allocated = 0
        self.pages_freed = 0
        # cross-tenant prefix sharing: prompt radix index + counters
        self.prefix = PrefixIndex(tokens_per_page)
        self.shared_pages_total = 0
        self.cow_copies_total = 0
        # opaque device-side page pool (e.g. {"k_pages": ..., "v_pages":
        # ...}) bound by the engine when the arena is the physical
        # backing store for decode; the allocator only hands it around
        self._store: Any = None
        # tensor-parallel serving: the engine sets this to the mesh size
        # when the bound store is head-sharded — every page table entry
        # then addresses tp_shards physical slices of that page, one per
        # device, and per-shard byte accounting divides accordingly
        self.tp_shards = 1

    # -- device store (the physical page tensors) --------------------------

    def bind_store(self, store: Any) -> None:
        """Attach the device page pool this allocator's tables index into."""
        self._store = store

    @property
    def store(self) -> Any:
        return self._store

    def swap_store(self, store: Any) -> Any:
        """Replace the device pool, returning the old one (donation-safe)."""
        old, self._store = self._store, store
        return old

    def add_sequence(self, seq_id: str) -> None:
        self.arena.create_region(seq_id, self.max_seq_pages * self.arena.page_bytes)
        self._tokens[seq_id] = 0
        self._seq_pages[seq_id] = []
        self._own_pages[seq_id] = []

    def has_sequence(self, seq_id: str) -> bool:
        """True while ``seq_id`` still owns pages (evicted-but-resident)."""
        return seq_id in self._tokens

    def _unmap_page(self, seq_id: str, page: int) -> None:
        """Drop one mapping claim; free the page when the last one dies."""
        mappers = self._mappers.get(page)
        if mappers is None or seq_id not in mappers:
            return
        mappers.discard(seq_id)
        collided = page in self._collided
        if collided:
            # each collider did its own physical fault (that is what
            # made it a collision), so the ledger frees one per claim
            self.pages_freed += 1
        if mappers:
            if self._owner.get(page) == seq_id:
                # a multi-mapped page outlived its recorded owner: hand
                # the record to a surviving claimant so a third sequence
                # faulting this page is still flagged as a collision
                self._owner[page] = sorted(mappers)[0]
            return
        del self._mappers[page]
        self._owner.pop(page, None)
        self._collided.discard(page)
        if not collided:
            self.pages_freed += 1
        home = self._page_home.pop(page, None)
        zpages = self._zombies.get(home)
        if zpages is not None:
            zpages.discard(page)
            if not zpages:
                del self._zombies[home]
                self.arena.destroy_region(home)

    def drop_sequence(self, seq_id: str) -> None:
        self._tokens.pop(seq_id)
        self._poisoned.discard(seq_id)
        self._collisions.discard(seq_id)
        self.prefix.remove(seq_id)
        for page in self._seq_pages.pop(seq_id, ()):
            self._unmap_page(seq_id, page)
        own = self._own_pages.pop(seq_id, [])
        still_mapped = {p for p in own if self._mappers.get(p)}
        if still_mapped:
            # pages another sequence still maps outlive the region that
            # faulted them: retire the region under a unique zombie name
            # (request ids recycle) and destroy it with its last page
            zname = f"{seq_id}~z{self._zombie_seq}"
            self._zombie_seq += 1
            self.arena.rename_region(seq_id, zname)
            self._zombies[zname] = still_mapped
            for p in still_mapped:
                self._page_home[p] = zname
        else:
            self.arena.destroy_region(seq_id)

    def _track_new_pages(self, seq_id: str, *, map_logical: bool = True) -> None:
        pages = self.arena.physical_pages(seq_id)
        known = self._own_pages[seq_id]
        for page in (int(p) for p in pages[len(known):]):
            mappers = self._mappers.get(page)
            if mappers and mappers != {seq_id}:
                # a fresh fault landing on a page some live sequence
                # already maps = arena corruption, even when the page is
                # legitimately multi-mapped via share_prefix — sharing
                # adds mappers, it never re-faults backing storage
                self._collisions.add(seq_id)
                self._collisions.update(mappers)
                self._collided.add(page)
                mappers.add(seq_id)
            else:
                self._mappers.setdefault(page, set()).add(seq_id)
                self._owner.setdefault(page, seq_id)
            self._page_home.setdefault(page, seq_id)
            known.append(page)
            if map_logical:
                self._seq_pages[seq_id].append(page)
            self.pages_allocated += 1

    def append_tokens(self, seq_id: str, n: int = 1) -> None:
        have = self._tokens[seq_id]
        need_pages = -(-(have + n) // self.tokens_per_page)
        have_pages = len(self._seq_pages[seq_id])
        if need_pages > have_pages:
            self.arena.grow(seq_id, (need_pages - have_pages) * self.arena.page_bytes)
            self._track_new_pages(seq_id)
        self._tokens[seq_id] = have + n

    def ensure_tokens(self, seq_id: str, n: int) -> None:
        """Grow ``seq_id`` to at least ``n`` tokens (idempotent).

        The paged decode path reserves the slot for this step's token
        *before* launching the kernel; an eviction racing in between
        re-admits the sequence at its request-derived length, so the
        reservation must be replayable without double-counting.
        """
        have = self._tokens[seq_id]
        if n > have:
            self.append_tokens(seq_id, n - have)

    # ------------------------------------------- cross-tenant page sharing

    def share_prefix(self, seq_id: str, donor_id: str, n_tokens: int) -> int:
        """Map ``donor_id``'s first pages read-only into fresh ``seq_id``.

        The sharer's first ``n_tokens`` positions resolve to the donor's
        physical pages (including a trailing partial page when the match
        is not page-aligned); per-page mapper sets act as refcounts.  No
        backing storage is faulted, so the page ledger does not move.
        Returns the number of pages shared.
        """
        if self._tokens[seq_id] != 0 or self._seq_pages[seq_id]:
            raise ValueError(
                f"{seq_id!r}: share_prefix needs a fresh sequence"
            )
        if donor_id not in self._tokens:
            raise KeyError(donor_id)
        if n_tokens <= 0 or n_tokens > self._tokens[donor_id]:
            raise ValueError(
                f"shared prefix of {n_tokens} tokens exceeds donor "
                f"{donor_id!r} ({self._tokens[donor_id]} tokens)"
            )
        n_pages = -(-n_tokens // self.tokens_per_page)
        donor_pages = self._seq_pages[donor_id][:n_pages]
        if len(donor_pages) < n_pages:
            raise ValueError(f"donor {donor_id!r} pages not resident")
        for page in donor_pages:
            self._mappers[page].add(seq_id)
        self._seq_pages[seq_id] = list(donor_pages)
        self._tokens[seq_id] = n_tokens
        self.shared_pages_total += n_pages
        return n_pages

    def page_writable(self, seq_id: str, logical: int) -> bool:
        """True when ``seq_id`` is the sole mapper of its logical page.

        Any write to a page with other mappers must :meth:`cow_page`
        first — the other sequences read those rows as their prefix.
        """
        page = self._seq_pages[seq_id][logical]
        return len(self._mappers.get(page, ())) <= 1

    def cow_page(self, seq_id: str, logical: int) -> Tuple[int, int]:
        """Copy-on-write: remap a shared logical page onto a fresh fault.

        Faults one page from ``seq_id``'s own region, points the logical
        slot at it, and drops the claim on the shared source (which the
        remaining mappers keep).  Returns ``(src, dst)`` physical pages;
        the caller copies the device rows src -> dst before writing.
        """
        src = self._seq_pages[seq_id][logical]
        if len(self._mappers.get(src, ())) <= 1:
            raise ValueError(f"page {src} is not shared; nothing to copy")
        self.arena.grow(seq_id, self.arena.page_bytes)
        before = len(self._own_pages[seq_id])
        self._track_new_pages(seq_id, map_logical=False)
        dst = self._own_pages[seq_id][before]
        self._seq_pages[seq_id][logical] = dst
        self._unmap_page(seq_id, src)
        self.cow_copies_total += 1
        return src, dst

    def sequence_shared(self, seq_id: str) -> bool:
        """True when any of ``seq_id``'s pages has another live mapper."""
        return any(
            len(self._mappers.get(p, ())) > 1
            for p in self._seq_pages.get(seq_id, ())
        )

    def rename_sequence(self, old: str, new: str) -> None:
        """Re-key a live sequence (used to park retired prefix donors)."""
        if new in self._tokens:
            raise ValueError(f"sequence {new!r} exists")
        self._tokens[new] = self._tokens.pop(old)
        pages = self._seq_pages[new] = self._seq_pages.pop(old)
        own = self._own_pages[new] = self._own_pages.pop(old)
        for page in set(pages) | set(own):
            mappers = self._mappers.get(page)
            if mappers and old in mappers:
                mappers.discard(old)
                mappers.add(new)
            if self._owner.get(page) == old:
                self._owner[page] = new
        for page in own:
            if self._page_home.get(page) == old:
                self._page_home[page] = new
        self.arena.rename_region(old, new)
        if old in self._poisoned:
            self._poisoned.discard(old)
            self._poisoned.add(new)
        if old in self._collisions:
            self._collisions.discard(old)
            self._collisions.add(new)
        self.prefix.rename(old, new)

    def register_prefix(self, seq_id: str, tokens: Sequence[int]) -> None:
        """Index ``seq_id``'s prompt once its K/V rows are resident."""
        if seq_id not in self._tokens:
            raise KeyError(seq_id)
        self.prefix.insert(seq_id, tokens)

    def lookup_prefix(
        self, tokens: Sequence[int], exclude: Sequence[str] = ()
    ) -> Tuple[Optional[str], int]:
        """Longest indexed prefix of ``tokens`` held by a trusted donor."""

        def eligible(s: str) -> bool:
            return (
                s in self._tokens
                and s not in exclude
                and s not in self._poisoned
                and s not in self._collisions
            )

        return self.prefix.lookup(tokens, eligible)

    def live_pages(self) -> int:
        """Physical pages with at least one mapper (zero after drain)."""
        return len(self._mappers)

    def sequence_ids(self) -> List[str]:
        """Every resident sequence (live, evicted-but-resident, parked).

        Sorted, so replica evacuation drops them in deterministic order.
        """
        return sorted(self._tokens)

    def shard_stats(self) -> Dict[str, int]:
        """Per-device view of the page ledger under tensor parallelism.

        Page allocation is a table edit shared by every shard (one fault
        maps the page on all ``tp_shards`` devices at once), so the
        *counts* are identical per shard and leak checks apply shard-
        for-shard; only the bytes divide.  ``live_pages_per_shard`` must
        be zero after drain on every device — a leak on any shard is a
        leak, there is no averaging it away.
        """
        per_shard_bytes = self.arena.page_bytes // max(self.tp_shards, 1)
        return {
            "tp_shards": self.tp_shards,
            "pages_allocated_per_shard": self.pages_allocated,
            "pages_freed_per_shard": self.pages_freed,
            "live_pages_per_shard": self.live_pages(),
            "page_bytes_per_shard": per_shard_bytes,
            "live_bytes_per_shard": self.live_pages() * per_shard_bytes,
        }

    def zombie_regions(self) -> List[str]:
        """Regions of dropped sequences still pinned by shared pages."""
        return sorted(self._zombies)

    def token_positions(
        self, seq_id: str, start: int, count: int
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Physical ``(page_ids, offsets)`` of tokens [start, start+count).

        The scatter targets for writing K/V rows into the device pool:
        token ``i`` of the sequence lives at row ``offsets[i-start]`` of
        physical page ``page_ids[i-start]``.  All addressed tokens must
        already be allocated (``ensure_tokens``/``append_tokens`` first).
        """
        pages = self._seq_pages[seq_id]
        idx = np.arange(start, start + count)
        logical = idx // self.tokens_per_page
        if count and logical[-1] >= len(pages):
            raise IndexError(
                f"{seq_id!r}: token {start + count - 1} beyond the "
                f"{len(pages)} allocated pages"
            )
        page_ids = np.asarray([pages[i] for i in logical], np.int32)
        offsets = np.asarray(idx % self.tokens_per_page, np.int32)
        return page_ids, offsets

    def sequence(self, seq_id: str) -> SequencePages:
        return SequencePages(
            seq_id,
            self._tokens[seq_id],
            np.asarray(self._seq_pages[seq_id], np.int32),
        )

    def resident_tokens(self, seq_id: str) -> int:
        """Tokens allocated (and, for chunked prefill, scattered) so far.

        Chunked prefill allocates chunk-by-chunk, so mid-prefill this is
        the last chunk boundary — the position a partially-prefilled
        sequence resumes from after an eviction that kept its pages.
        Returns 0 for unknown sequences (dropped pages = no progress).
        """
        return self._tokens.get(seq_id, 0)

    def page_table(
        self,
        max_pages: Optional[int] = None,
        seq_ids: Optional[Sequence[Optional[str]]] = None,
    ) -> np.ndarray:
        """Dense int32 table of physical page ids, -1 padded.

        Without ``seq_ids``: one row per live sequence in sorted order
        (the diagnostics/report view).  With ``seq_ids``: one row per
        entry in the given order — the decode view, where row i is slot
        i's sequence and ``None`` entries (empty slots) render as all--1
        rows the kernel masks out.
        """
        if seq_ids is None:
            seq_ids = sorted(self._tokens)
        if max_pages is None:
            max_pages = max(
                (len(self._seq_pages[s]) for s in seq_ids if s is not None),
                default=0,
            )
        table = np.full((len(seq_ids), max_pages), -1, dtype=np.int32)
        for i, s in enumerate(seq_ids):
            if s is None:
                continue
            p = self._seq_pages[s]
            table[i, : len(p)] = p
        return table

    def seq_lens(
        self, seq_ids: Optional[Sequence[Optional[str]]] = None
    ) -> np.ndarray:
        if seq_ids is None:
            seq_ids = sorted(self._tokens)
        return np.asarray(
            [0 if s is None else self._tokens[s] for s in seq_ids], np.int32
        )

    def total_runs(self) -> int:
        return sum(self.arena.fragmentation_report().values())

    # ---------------------------------------------- poison / validate hook

    def poison_sequence(self, seq_id: str) -> bool:
        """Mark a live sequence's KV pages as corrupted (fault injection).

        Models a DMA scribble / bad host page hitting one sequence's
        cache.  The serving engine polls :meth:`validate` at step
        boundaries and must evict (and re-prefill) poisoned sequences
        rather than decode from them.  Returns False for unknown ids.
        """
        if seq_id not in self._tokens:
            return False
        self._poisoned.add(seq_id)
        # corrupt rows are read by every sequence mapping those pages as
        # its prefix, so poison propagates to all co-mappers; lookup
        # excludes poisoned donors, so nobody shares *into* the blast
        for page in self._seq_pages.get(seq_id, ()):
            for other in self._mappers.get(page, ()):
                if other in self._tokens:
                    self._poisoned.add(other)
        return True

    def poisoned(self) -> List[str]:
        """Sequences currently marked poisoned (sorted)."""
        return sorted(self._poisoned)

    def validate(self) -> List[str]:
        """Sequences whose KV pages cannot be trusted (sorted).

        Explicitly poisoned sequences, plus any pair of live sequences
        whose physical pages collide — two owners of one backing page is
        arena corruption regardless of how it happened.  Collisions are
        detected incrementally as pages fault in, so polling this on
        every decode step is O(result), not O(sequences x pages).
        """
        return sorted(
            s for s in self._poisoned | self._collisions
            if s in self._tokens
        )
