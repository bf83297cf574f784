"""SELF image loader — the paper's §IV.B zeroing-semantics fix.

Linux, for a PT_LOAD with ``MemSiz > FileSiz``, zeroes **only**
``[vaddr+FileSiz, vaddr+MemSiz)`` — the range the program header
prescribes.  Legacy gVisor zeroed the **full page-aligned extension**
``[vaddr+FileSiz, page_up(vaddr+MemSiz))``, destroying bytes (e.g. a
``DYNAMIC`` section) that live outside every LOAD segment but inside the
shared file page.  The result in the paper was a segfault in the
``prophet`` package; here it is :class:`SegfaultError` raised when a
section checksum no longer matches.

:class:`ImageLoader` implements both behaviours behind
``semantics="linux" | "legacy"`` and is the loader used by the checkpoint
subsystem (tensor segments are lane-tile padded, so ``memsz > filesz`` is
the common case, not the corner case).
"""

from __future__ import annotations

import zlib
from dataclasses import dataclass


from .elf import PAGE_SIZE, PT_LOAD, BadImageError, SELFImage, read_self

__all__ = ["ImageLoader", "LoadedImage", "SegfaultError", "ZeroStats"]


class SegfaultError(RuntimeError):
    """Loaded image is corrupt (the paper's prophet segfault analogue)."""


@dataclass
class ZeroStats:
    """How many bytes each semantics zeroed — used by loader_bench."""

    prescribed: int = 0     # [filesz, memsz) — what the header asks for
    page_extension: int = 0  # extra bytes the legacy loader also zeroes


@dataclass
class LoadedImage:
    memory: bytearray
    base: int
    image: SELFImage
    zero_stats: ZeroStats

    def read(self, vaddr: int, size: int) -> bytes:
        off = vaddr - self.base
        if off < 0 or off + size > len(self.memory):
            raise SegfaultError(f"read outside image at {vaddr:#x}")
        return bytes(self.memory[off : off + size])

    def section_bytes(self, name: str) -> bytes:
        sec = self.image.section(name)
        return self.read(sec.sh_addr, sec.sh_size)

    def verify_section(self, name: str) -> None:
        sec = self.image.section(name)
        data = self.section_bytes(name)
        if zlib.crc32(data) != sec.crc32:
            raise SegfaultError(
                f"segmentation fault: section {name!r} corrupted during load "
                f"(crc mismatch — see paper §IV.B)"
            )

    def verify_all(self) -> None:
        for sec in self.image.sections:
            self.verify_section(sec.name)


class ImageLoader:
    """Maps SELF LOAD segments into a flat memory image.

    ``semantics="linux"``  — zero exactly ``[filesz, memsz)`` (the fix).
    ``semantics="legacy"`` — zero ``[filesz, page_up(memsz))`` (the bug).
    """

    def __init__(self, semantics: str = "linux") -> None:
        if semantics not in ("linux", "legacy"):
            raise ValueError(semantics)
        self.semantics = semantics

    def load(self, blob: bytes, *, verify: bool = True) -> LoadedImage:
        img = read_self(blob)
        loads = [p for p in img.phdrs if p.p_type == PT_LOAD]
        if not loads:
            raise BadImageError("no LOAD segments")
        base = _page_down(min(p.p_vaddr for p in loads))
        top = max(_page_up(p.p_vaddr + max(p.p_memsz, p.p_filesz)) for p in loads)
        mem = bytearray(top - base)
        stats = ZeroStats()

        for ph in loads:
            # 1. map the file pages covering [vaddr, vaddr+filesz) — page
            #    granular, so trailing in-page file bytes (possibly another
            #    section's content) arrive too.  This mirrors mmap of the
            #    ELF file page.
            file_lo = _page_down(ph.p_offset)
            file_hi = min(_page_up(ph.p_offset + ph.p_filesz), len(img.payload))
            va_lo = _page_down(ph.p_vaddr)
            chunk = img.payload[file_lo:file_hi]
            mem[va_lo - base : va_lo - base + len(chunk)] = chunk

            # 2. zero-fill per the semantics under test.
            z_lo = ph.p_vaddr + ph.p_filesz
            z_hi_linux = ph.p_vaddr + ph.p_memsz
            z_hi_legacy = _page_up(ph.p_vaddr + ph.p_memsz)
            stats.prescribed += max(0, z_hi_linux - z_lo)
            stats.page_extension += max(0, z_hi_legacy - max(z_lo, z_hi_linux))
            z_hi = z_hi_linux if self.semantics == "linux" else z_hi_legacy
            if z_hi > z_lo:
                mem[z_lo - base : z_hi - base] = b"\0" * (z_hi - z_lo)

        loaded = LoadedImage(mem, base, img, stats)
        if verify:
            loaded.verify_all()
        return loaded


def _page_down(x: int) -> int:
    return x // PAGE_SIZE * PAGE_SIZE


def _page_up(x: int) -> int:
    return (x + PAGE_SIZE - 1) // PAGE_SIZE * PAGE_SIZE
