"""Virtual-memory-area machinery for the SEE++ sandbox (paper §IV.A).

This module reproduces, mechanically, the memory-management behaviour the
paper describes inside gVisor's Sentry:

* a virtual **address space** whose regions ("VMAs") are allocated
  **top-down** (new regions placed below existing ones), as gVisor does for
  ``mmap`` without ``MAP_FIXED``;
* a **backing store** ("memfd") whose offsets are handed out by a
  :class:`FileRangeAllocator` that can allocate **bottom-up** (lowest free
  offset first) or **top-down** (highest free offset first);
* sentry-side **VMA merging** (adjacent + same flags), which in the legacy
  implementation *drops* the per-VMA ``last_fault`` hint — the paper calls
  this out as compounding the bug;
* the **host-kernel coalescing rule**: two host mappings merge iff they are
  address-contiguous AND offset-contiguous (in the same direction) AND have
  identical flags.  The observable metric is the *host VMA count*, which is
  what blows past Linux's ``vm.max_map_count`` (65,530) in the paper.

The paper's bug: when a VMA has no last-faulted address, the legacy
allocator defaults to **bottom-up** file-offset allocation even though the
address space grows **top-down**.  Address-adjacent fault chunks therefore
receive offsets running the *wrong way*, the host kernel can never coalesce
them, and the host VMA count explodes (>500x).  The paper's fix — exposed
here as :class:`MMConfig` flags — aligns the offset-allocation direction
with the address-space growth direction and preserves ``last_fault`` across
merges (182x reduction on the list-append benchmark).
"""

from __future__ import annotations

import bisect
import enum
from dataclasses import dataclass, replace
from typing import Iterator, List, Optional, Tuple

__all__ = [
    "Direction",
    "AddrRange",
    "VMA",
    "VMASet",
    "FileRangeAllocator",
    "HostMapping",
    "coalesce_host_mappings",
    "VMAExhaustedError",
    "OutOfMemoryError",
]

#: Linux default ``vm.max_map_count`` — the crash threshold in the paper.
MAX_MAP_COUNT = 65_530


class VMAExhaustedError(RuntimeError):
    """Raised when the host VMA count exceeds ``vm.max_map_count``.

    This is the sandbox crash the paper's §IV.A workload triggered.
    """


class OutOfMemoryError(RuntimeError):
    """Backing store or address space exhausted."""


class Direction(enum.Enum):
    BOTTOM_UP = "bottom_up"  # ascending offsets / addresses
    TOP_DOWN = "top_down"    # descending offsets / addresses


@dataclass(frozen=True, order=True)
class AddrRange:
    """Half-open range ``[start, end)``."""

    start: int
    end: int

    def __post_init__(self) -> None:
        if self.end < self.start:
            raise ValueError(f"bad range [{self.start:#x}, {self.end:#x})")

    @property
    def length(self) -> int:
        return self.end - self.start

    def overlaps(self, other: "AddrRange") -> bool:
        return self.start < other.end and other.start < self.end

    def contains(self, addr: int) -> bool:
        return self.start <= addr < self.end

    def intersect(self, other: "AddrRange") -> Optional["AddrRange"]:
        s, e = max(self.start, other.start), min(self.end, other.end)
        return AddrRange(s, e) if s < e else None


@dataclass
class VMA:
    """A sentry-side virtual memory area.

    ``last_fault`` is the address of the most recent page fault inside this
    VMA.  gVisor uses it to infer the access direction for backing-offset
    allocation; the paper's fix preserves it across merges.
    """

    ar: AddrRange
    flags: int = 0
    last_fault: Optional[int] = None
    #: monotone sequence number of the last fault (used to pick the more
    #: recent hint when two merged VMAs both carry one).
    last_fault_seq: int = -1

    @property
    def start(self) -> int:
        return self.ar.start

    @property
    def end(self) -> int:
        return self.ar.end


class VMASet:
    """Ordered set of non-overlapping sentry VMAs with gap-finding.

    Mirrors gVisor's ``vma set``: insertion merges adjacent VMAs with equal
    flags.  Whether the merge preserves the ``last_fault`` hint is the
    paper's second bug knob (``preserve_hint_on_merge``).
    """

    def __init__(
        self,
        as_size: int,
        *,
        preserve_hint_on_merge: bool,
        as_direction: Direction = Direction.TOP_DOWN,
    ) -> None:
        self.as_size = as_size
        self.as_direction = as_direction
        self.preserve_hint_on_merge = preserve_hint_on_merge
        self._starts: List[int] = []
        self._vmas: List[VMA] = []

    # -- queries ---------------------------------------------------------

    def __len__(self) -> int:
        return len(self._vmas)

    def __iter__(self) -> Iterator[VMA]:
        return iter(self._vmas)

    def find(self, addr: int) -> Optional[VMA]:
        i = bisect.bisect_right(self._starts, addr) - 1
        if i >= 0 and self._vmas[i].ar.contains(addr):
            return self._vmas[i]
        return None

    def overlapping(self, ar: AddrRange) -> List[VMA]:
        out = []
        i = bisect.bisect_right(self._starts, ar.start) - 1
        if i < 0:
            i = 0
        while i < len(self._vmas):
            v = self._vmas[i]
            if v.ar.start >= ar.end:
                break
            if v.ar.overlaps(ar):
                out.append(v)
            i += 1
        return out

    # -- gap finding (address-space allocation) ---------------------------

    def find_gap(self, length: int, direction: Optional[Direction] = None) -> int:
        """Find a free address range of ``length``; gVisor-style.

        TOP_DOWN returns the *highest* free range (so successive unhinted
        mmaps stack downward), BOTTOM_UP the lowest.
        """
        direction = direction or self.as_direction
        gaps = self._gaps()
        if direction is Direction.TOP_DOWN:
            for gs, ge in reversed(gaps):
                if ge - gs >= length:
                    return ge - length
        else:
            for gs, ge in gaps:
                if ge - gs >= length:
                    return gs
        raise OutOfMemoryError(f"no {length:#x}-byte gap in address space")

    def _gaps(self) -> List[Tuple[int, int]]:
        gaps = []
        prev = 0
        for v in self._vmas:
            if v.ar.start > prev:
                gaps.append((prev, v.ar.start))
            prev = v.ar.end
        if prev < self.as_size:
            gaps.append((prev, self.as_size))
        return gaps

    # -- mutation ----------------------------------------------------------

    def insert(self, vma: VMA) -> VMA:
        """Insert ``vma`` and merge with adjacent same-flag neighbours.

        Returns the (possibly merged) VMA now covering ``vma.ar``.
        LEGACY semantics (``preserve_hint_on_merge=False``): a merge drops
        ``last_fault`` — the compounding bug from the paper.
        """
        if self.overlapping(vma.ar):
            raise ValueError(f"overlapping mapping at [{vma.start:#x},{vma.end:#x})")
        i = bisect.bisect_left(self._starts, vma.ar.start)
        self._starts.insert(i, vma.ar.start)
        self._vmas.insert(i, vma)
        # try merge with successor first, then predecessor.
        merged = vma
        j = self._vmas.index(merged)
        if j + 1 < len(self._vmas):
            merged = self._maybe_merge(j, j + 1) or merged
        j = self._vmas.index(merged)
        if j - 1 >= 0:
            merged = self._maybe_merge(j - 1, j) or merged
        return merged

    def remove(self, ar: AddrRange) -> None:
        """Unmap ``ar`` exactly (must match whole VMAs or split them)."""
        keep: List[VMA] = []
        for v in self._vmas:
            inter = v.ar.intersect(ar)
            if inter is None:
                keep.append(v)
                continue
            if v.ar.start < inter.start:
                keep.append(replace(v, ar=AddrRange(v.ar.start, inter.start)))
            if inter.end < v.ar.end:
                keep.append(replace(v, ar=AddrRange(inter.end, v.ar.end)))
        keep.sort(key=lambda v: v.ar.start)
        self._vmas = keep
        self._starts = [v.ar.start for v in keep]

    def note_fault(self, vma: VMA, addr: int, seq: int) -> None:
        vma.last_fault = addr
        vma.last_fault_seq = seq

    def _maybe_merge(self, i: int, j: int) -> Optional[VMA]:
        a, b = self._vmas[i], self._vmas[j]
        if a.ar.end != b.ar.start or a.flags != b.flags:
            return None
        if self.preserve_hint_on_merge:
            # Paper's fix: keep the *more recent* hint.
            if a.last_fault_seq >= b.last_fault_seq:
                hint, seq = a.last_fault, a.last_fault_seq
            else:
                hint, seq = b.last_fault, b.last_fault_seq
        else:
            hint, seq = None, -1  # legacy: dropped on merge
        merged = VMA(AddrRange(a.ar.start, b.ar.end), a.flags, hint, seq)
        self._vmas[i : j + 1] = [merged]
        self._starts[i : j + 1] = [merged.ar.start]
        return merged


class FileRangeAllocator:
    """Backing-store ("memfd") offset allocator with directional policy.

    Free space is a sorted list of half-open ranges.  ``allocate`` takes the
    lowest free range (BOTTOM_UP) or the highest (TOP_DOWN).  This is the
    knob whose default the paper fixed.
    """

    def __init__(self, size: int) -> None:
        self.size = size
        self._free: List[Tuple[int, int]] = [(0, size)]
        self.allocated_bytes = 0

    def allocate(self, length: int, direction: Direction) -> AddrRange:
        if direction is Direction.BOTTOM_UP:
            it = enumerate(self._free)
            for i, (s, e) in it:
                if e - s >= length:
                    self._take(i, s, s + length)
                    return AddrRange(s, s + length)
        else:
            for i in range(len(self._free) - 1, -1, -1):
                s, e = self._free[i]
                if e - s >= length:
                    self._take(i, e - length, e)
                    return AddrRange(e - length, e)
        raise OutOfMemoryError(f"backing store exhausted ({length} bytes)")

    def free(self, fr: AddrRange) -> None:
        i = bisect.bisect_left(self._free, (fr.start, fr.end))
        self._free.insert(i, (fr.start, fr.end))
        self.allocated_bytes -= fr.length
        self._coalesce_free()

    def _take(self, i: int, s: int, e: int) -> None:
        fs, fe = self._free.pop(i)
        assert fs <= s and e <= fe
        pieces = []
        if fs < s:
            pieces.append((fs, s))
        if e < fe:
            pieces.append((e, fe))
        self._free[i:i] = pieces
        self.allocated_bytes += e - s

    def _coalesce_free(self) -> None:
        out: List[Tuple[int, int]] = []
        for s, e in sorted(self._free):
            if out and out[-1][1] == s:
                out[-1] = (out[-1][0], e)
            else:
                out.append((s, e))
        self._free = out


@dataclass(frozen=True)
class HostMapping:
    """One sentry→host mapping: addr range backed by a memfd offset range."""

    addr: AddrRange
    offset: int  # backing-store offset of addr.start
    flags: int = 0

    @property
    def offset_end(self) -> int:
        return self.offset + self.addr.length


def coalesce_host_mappings(mappings: List[HostMapping]) -> List[HostMapping]:
    """Apply the host-kernel VMA merge rule.

    Two mappings merge iff address-contiguous AND offset-contiguous AND
    same flags — i.e. ``b.addr.start == a.addr.end`` and
    ``b.offset == a.offset_end``.  The *count* of the result is the host
    VMA count that the paper's workload blew past 65,530.
    """
    out: List[HostMapping] = []
    for m in sorted(mappings, key=lambda m: m.addr.start):
        if (
            out
            and out[-1].addr.end == m.addr.start
            and out[-1].offset_end == m.offset
            and out[-1].flags == m.flags
        ):
            prev = out[-1]
            out[-1] = HostMapping(
                AddrRange(prev.addr.start, m.addr.end), prev.offset, prev.flags
            )
        else:
            out.append(m)
    return out
