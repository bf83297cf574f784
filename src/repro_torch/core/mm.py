"""Sentry memory manager — the paper's §IV.A bug and fix, end to end.

:class:`MemoryManager` glues together the address space (:class:`VMASet`),
the backing store (:class:`FileRangeAllocator`) and the fault path.  The two
behavioural knobs in :class:`MMConfig` are exactly the paper's before/after:

``align_offset_direction``
    *False* (legacy): a fault in a VMA with **no** ``last_fault`` hint
    allocates backing offsets **bottom-up**, even though the address space
    grows top-down — the root-cause misalignment.
    *True* (modern): the unhinted default follows the address-space growth
    direction, so offsets run the same way addresses do and the host kernel
    can coalesce.

``preserve_hint_on_merge``
    *False* (legacy): sentry-side VMA merges drop ``last_fault`` —
    "compounding the problem by further preventing correct allocation
    direction inference".
    *True* (modern): the hint survives merges.

``MMConfig.legacy()`` / ``MMConfig.modern()`` build the two configurations
benchmarked in ``benchmarks/vma_bench.py``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

from .vma import (
    MAX_MAP_COUNT,
    AddrRange,
    Direction,
    FileRangeAllocator,
    HostMapping,
    VMA,
    VMAExhaustedError,
    VMASet,
    coalesce_host_mappings,
)

__all__ = ["MMConfig", "MemoryManager", "FaultRecord"]

#: Default fault granule: 64 KiB — a TPU-DMA-friendly granule standing in
#: for gVisor's page-chunked fault handling (see DESIGN.md assumption 3).
DEFAULT_GRANULE = 64 * 1024


@dataclass(frozen=True)
class MMConfig:
    """Behavioural switches for the memory manager (paper §IV.A)."""

    align_offset_direction: bool
    preserve_hint_on_merge: bool
    as_direction: Direction = Direction.TOP_DOWN
    granule: int = DEFAULT_GRANULE
    as_size: int = 1 << 40          # 1 TiB virtual address space
    backing_size: int = 1 << 38     # 256 GiB backing store
    max_map_count: int = MAX_MAP_COUNT
    #: if True, exceeding max_map_count raises (the paper's sandbox crash);
    #: if False we only record the high-water mark (for benchmarking).
    enforce_map_count: bool = False

    @classmethod
    def legacy(cls, **kw) -> "MMConfig":
        return cls(align_offset_direction=False, preserve_hint_on_merge=False, **kw)

    @classmethod
    def modern(cls, **kw) -> "MMConfig":
        return cls(align_offset_direction=True, preserve_hint_on_merge=True, **kw)


@dataclass
class FaultRecord:
    addr: int
    length: int
    offset: int
    direction: Direction
    hinted: bool


class MemoryManager:
    """gVisor-Sentry-style MM: mmap / touch(fault) / munmap / host view."""

    def __init__(self, config: MMConfig) -> None:
        self.config = config
        self.vmas = VMASet(
            config.as_size,
            preserve_hint_on_merge=config.preserve_hint_on_merge,
            as_direction=config.as_direction,
        )
        self.backing = FileRangeAllocator(config.backing_size)
        # granule-aligned addr -> HostMapping (one per faulted granule)
        self._mappings: Dict[int, HostMapping] = {}
        # len(coalesce_host_mappings(list(self._mappings.values()))), kept
        # up to date as mappings come and go (see _joined)
        self._host_vmas = 0
        self._fault_seq = 0
        self.fault_log: List[FaultRecord] = []
        self.host_vma_high_water = 0

    # ------------------------------------------------------------------ mmap

    def mmap(self, length: int, flags: int = 0, addr: Optional[int] = None) -> AddrRange:
        """Reserve an address range (no backing until faulted)."""
        length = self._align_up(length)
        if addr is None:
            addr = self.vmas.find_gap(length)
        ar = AddrRange(addr, addr + length)
        self.vmas.insert(VMA(ar, flags))
        return ar

    def munmap(self, ar: AddrRange) -> None:
        self.vmas.remove(ar)
        g = self.config.granule
        first = self._align_up(ar.start)
        if (ar.end - first) // g > len(self._mappings):
            starts = [s for s in self._mappings if ar.start <= s < ar.end]
        else:
            starts = [s for s in range(first, ar.end, g) if s in self._mappings]
        for start in starts:
            self._host_vmas -= 1 - self._joined(start - g) - self._joined(start)
            m = self._mappings.pop(start)
            self.backing.free(AddrRange(m.offset, m.offset_end))

    # ----------------------------------------------------------------- fault

    def touch(self, addr: int, length: int = 1) -> None:
        """Simulate the application touching ``[addr, addr+length)``.

        Each unbacked granule-aligned chunk takes a fault; the fault path
        allocates backing offsets using the direction heuristic under test.
        Contiguous unbacked granules inside one touch are faulted as one
        chunk (gVisor, like Linux, services a fault for a whole run).
        """
        start = self._align_down(addr)
        end = self._align_up(addr + length)
        g = self.config.granule
        run_start: Optional[int] = None
        a = start
        while a < end:
            backed = a in self._mappings
            if not backed and run_start is None:
                run_start = a
            if (backed or a + g >= end) and run_start is not None:
                run_end = a if backed else a + g
                self._fault(run_start, run_end - run_start)
                run_start = None
            a += g

    def _fault(self, addr: int, length: int) -> None:
        vma = self.vmas.find(addr)
        if vma is None:
            raise RuntimeError(f"SIGSEGV: fault at unmapped {addr:#x}")
        direction, hinted = self._infer_direction(vma, addr)
        fr = self.backing.allocate(length, direction)
        self._fault_seq += 1
        self.vmas.note_fault(vma, addr, self._fault_seq)
        g = self.config.granule
        # record one host mapping per granule (the host kernel sees each
        # mmap(memfd, offset) as a candidate VMA; coalescing is computed in
        # host_vmas()).  Offsets are laid out across the chunk in the
        # allocation direction, exactly as gVisor fills a chunked fault.
        n = length // g
        for i in range(n):
            a_i = addr + i * g
            off_i = fr.start + i * g
            self._mappings[a_i] = HostMapping(AddrRange(a_i, a_i + g), off_i, vma.flags)
        # the chunk is one run to the host (contiguous addresses and
        # offsets, one flags value), which may merge at either end
        self._host_vmas += 1 - self._joined(addr - g) - self._joined(addr + length - g)
        self.fault_log.append(FaultRecord(addr, length, fr.start, direction, hinted))
        # The count is kept as mappings come and go, so the check is O(1); per
        # fault it runs only when the crash threshold is enforced (with
        # enforcement off, host_vma_count() samples the high-water mark).
        if self.config.enforce_map_count:
            self._note_host_vmas()

    def _infer_direction(self, vma: VMA, addr: int) -> tuple[Direction, bool]:
        """The paper's root cause lives here."""
        if vma.last_fault is not None:
            # Hinted: infer the access direction from the previous fault.
            if addr < vma.last_fault:
                return Direction.TOP_DOWN, True
            return Direction.BOTTOM_UP, True
        if self.config.align_offset_direction:
            # Paper's fix: unhinted default = address-space growth direction.
            return self.config.as_direction, False
        # Legacy bug: unhinted default = bottom-up, regardless of the
        # top-down address space.
        return Direction.BOTTOM_UP, False

    # ------------------------------------------------------------- host view

    def host_vmas(self) -> List[HostMapping]:
        return coalesce_host_mappings(list(self._mappings.values()))

    def _joined(self, a: int) -> bool:
        """Whether the host merges the mappings at ``a`` and ``a + g``.

        Every mapping is one aligned granule, so these two are the only
        candidates for address contiguity; the test is
        :func:`coalesce_host_mappings`'s own.
        """
        left = self._mappings.get(a)
        right = self._mappings.get(a + self.config.granule)
        return (left is not None and right is not None
                and left.offset_end == right.offset
                and left.flags == right.flags)

    def host_vma_count(self) -> int:
        n = self._host_vmas
        if n > self.host_vma_high_water:
            self.host_vma_high_water = n
        return n

    def _note_host_vmas(self) -> None:
        n = self.host_vma_count()
        if n > self.host_vma_high_water:
            self.host_vma_high_water = n
        if self.config.enforce_map_count and n > self.config.max_map_count:
            raise VMAExhaustedError(
                f"host VMA count {n} exceeds vm.max_map_count "
                f"{self.config.max_map_count}: sandbox crash (paper §IV.A)"
            )

    # ----------------------------------------------------------------- misc

    def stats(self) -> Dict[str, int]:
        return {
            "sentry_vmas": len(self.vmas),
            "host_vmas": self.host_vma_count(),
            "host_vma_high_water": self.host_vma_high_water,
            "granule_mappings": len(self._mappings),
            "backing_bytes": self.backing.allocated_bytes,
            "faults": len(self.fault_log),
        }

    def _align_up(self, x: int) -> int:
        g = self.config.granule
        return (x + g - 1) // g * g

    def _align_down(self, x: int) -> int:
        return x // self.config.granule * self.config.granule
