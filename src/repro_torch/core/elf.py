"""SELF — a Snowpark-ELF-like segmented artifact format (paper §IV.B).

Checkpoints and op-artifacts in this framework are stored as SELF images:
a header, **program headers** (LOAD segments with separate ``filesz`` /
``memsz``, exactly ELF's ``p_filesz`` / ``p_memsz``), a **section table**
(named, checksummed ranges such as ``DYNAMIC``-style metadata), and raw
payload.  ``memsz >= filesz`` is routine here: tensor segments are padded in
memory to the TPU lane tile (128 elements) while the file stores only the
actual bytes.

The format deliberately admits the paper's Fig. 4 pathology: a section may
legally live *outside every LOAD segment* but *inside the page-aligned
extension* of one — its bytes come from the shared file page.  A loader
that zeroes the full page-aligned extension (legacy gVisor) destroys it;
a loader with Linux semantics (zero exactly ``[filesz, memsz)``) does not.
See :mod:`repro_torch.core.loader`.
"""

from __future__ import annotations

import json
import struct
import zlib
from dataclasses import dataclass
from typing import List, Optional, Tuple


__all__ = [
    "PAGE_SIZE",
    "LANE_TILE",
    "PT_LOAD",
    "PT_DYNAMIC",
    "ProgramHeader",
    "Section",
    "SELFImage",
    "SELFWriter",
    "read_self",
    "BadImageError",
]

PAGE_SIZE = 4096
#: TPU lane tile — in-memory tensor rows are padded to 128 elements.
LANE_TILE = 128

MAGIC = b"SELF"
VERSION = 2

PT_LOAD = 1
PT_DYNAMIC = 2

_PHDR = struct.Struct("<IIQQQQ")          # type, flags, offset, vaddr, filesz, memsz
_SHDR = struct.Struct("<32sIQQI")          # name, type, addr, size, crc32
_HDR = struct.Struct("<4sIII")             # magic, version, n_phdr, n_shdr


class BadImageError(ValueError):
    pass


@dataclass(frozen=True)
class ProgramHeader:
    p_type: int
    p_flags: int
    p_offset: int
    p_vaddr: int
    p_filesz: int
    p_memsz: int

    def __post_init__(self):
        if self.p_memsz < self.p_filesz:
            raise BadImageError("memsz < filesz")
        if self.p_offset % PAGE_SIZE != self.p_vaddr % PAGE_SIZE:
            raise BadImageError("offset/vaddr page congruence violated")


@dataclass(frozen=True)
class Section:
    name: str
    sh_type: int
    sh_addr: int
    sh_size: int
    crc32: int


@dataclass
class SELFImage:
    phdrs: List[ProgramHeader]
    sections: List[Section]
    payload: bytes  # full file image (headers + data)

    def section(self, name: str) -> Section:
        for s in self.sections:
            if s.name == name:
                return s
        raise KeyError(name)


class SELFWriter:
    """Builds a SELF image.

    Layout: header | phdr table | shdr table | padding-to-page | payload.
    ``add_segment`` returns the assigned vaddr; ``add_section`` registers a
    named checksummed range whose bytes the caller has already placed (via
    a segment's file bytes or ``add_raw``).
    """

    def __init__(self, base_vaddr: int = 0x10000) -> None:
        self._phdrs: List[ProgramHeader] = []
        self._sections: List[Tuple[str, int, int, int, bytes]] = []
        self._chunks: List[Tuple[int, bytes]] = []  # (file_offset, data)
        self._base = base_vaddr
        self._next_vaddr = base_vaddr
        self._next_off = 0  # payload-relative; fixed up at finish()

    # -- segments ----------------------------------------------------------

    def add_segment(
        self,
        data: bytes,
        *,
        memsz: Optional[int] = None,
        flags: int = 0,
        p_type: int = PT_LOAD,
        tail: bytes = b"",
    ) -> ProgramHeader:
        """Append a LOAD segment.

        ``memsz`` defaults to ``len(data)``; pass a larger value for a
        zero-fill (".bss") tail.  ``tail`` bytes are written into the file
        immediately after ``data`` — *inside the page-aligned extension but
        outside the segment* — which is exactly how the Fig. 4 DYNAMIC
        placement arises.  Returns the program header (vaddr assigned
        top-down-free, ascending here for file simplicity).
        """
        memsz = len(data) if memsz is None else memsz
        if memsz < len(data):
            raise BadImageError("memsz < filesz")
        # place segment at next page boundary, congruent offset
        vaddr = _align_up(self._next_vaddr, PAGE_SIZE)
        off = _align_up(self._next_off, PAGE_SIZE)
        ph = ProgramHeader(p_type, flags, off, vaddr, len(data), memsz)
        self._phdrs.append(ph)
        self._chunks.append((off, bytes(data)))
        if tail:
            self._chunks.append((off + len(data), bytes(tail)))
        self._next_vaddr = vaddr + max(memsz, len(data) + len(tail))
        self._next_off = off + len(data) + len(tail)
        return ph

    def tail_addr(self, ph: ProgramHeader) -> int:
        """Virtual address corresponding to the first byte after filesz."""
        return ph.p_vaddr + ph.p_filesz

    # -- sections ----------------------------------------------------------

    def add_section(
        self, name: str, sh_type: int, sh_addr: int, data: bytes
    ) -> Section:
        if len(name.encode()) > 31:
            raise BadImageError("section name too long")
        sec = Section(name, sh_type, sh_addr, len(data), zlib.crc32(data))
        self._sections.append((name, sh_type, sh_addr, len(data), data))
        return sec

    # -- finish --------------------------------------------------------------

    def finish(self) -> bytes:
        n_ph, n_sh = len(self._phdrs), len(self._sections)
        header_len = _HDR.size + n_ph * _PHDR.size + n_sh * _SHDR.size
        payload_base = _align_up(header_len, PAGE_SIZE)

        buf = bytearray(payload_base)
        _HDR.pack_into(buf, 0, MAGIC, VERSION, n_ph, n_sh)
        pos = _HDR.size
        for ph in self._phdrs:
            _PHDR.pack_into(
                buf, pos, ph.p_type, ph.p_flags, ph.p_offset + payload_base,
                ph.p_vaddr, ph.p_filesz, ph.p_memsz,
            )
            pos += _PHDR.size
        for name, sh_type, sh_addr, sh_size, data in self._sections:
            _SHDR.pack_into(
                buf, pos, name.encode().ljust(32, b"\0"), sh_type,
                sh_addr, sh_size, zlib.crc32(data),
            )
            pos += _SHDR.size

        end = payload_base
        for off, data in self._chunks:
            end = max(end, payload_base + off + len(data))
        buf.extend(b"\0" * (end - len(buf)))
        for off, data in self._chunks:
            buf[payload_base + off : payload_base + off + len(data)] = data
        return bytes(buf)


def read_self(blob: bytes) -> SELFImage:
    if blob[:4] != MAGIC:
        raise BadImageError("bad magic")
    magic, version, n_ph, n_sh = _HDR.unpack_from(blob, 0)
    if version != VERSION:
        raise BadImageError(f"unsupported version {version}")
    pos = _HDR.size
    phdrs = []
    for _ in range(n_ph):
        t, fl, off, va, fsz, msz = _PHDR.unpack_from(blob, pos)
        phdrs.append(ProgramHeader(t, fl, off, va, fsz, msz))
        pos += _PHDR.size
    sections = []
    for _ in range(n_sh):
        name, t, addr, size, crc = _SHDR.unpack_from(blob, pos)
        sections.append(Section(name.rstrip(b"\0").decode(), t, addr, size, crc))
        pos += _SHDR.size
    return SELFImage(phdrs, sections, blob)


def _align_up(x: int, a: int) -> int:
    return (x + a - 1) // a * a


# --------------------------------------------------------------------------
# convenience builders
# --------------------------------------------------------------------------

def build_prophet_like(payload: bytes = b"\xabprophet-stan-model\xcd" * 64) -> bytes:
    """Craft the paper's Fig. 4 pathology.

    One LOAD segment with ``memsz > filesz`` (a small zero-fill tail), and a
    ``DYNAMIC`` section whose bytes sit *after* ``memsz`` but *inside* the
    page-aligned extension — present in the file page, outside every LOAD
    directive.  A legacy loader (full page-extension zeroing) destroys the
    DYNAMIC content; a Linux-semantics loader preserves it.
    """
    w = SELFWriter()
    code = payload
    bss = 256                      # memsz - filesz zero-fill prescribed by header
    gap = 64                       # DYNAMIC starts this far beyond memsz
    dynamic = json.dumps(
        {"needed": ["libstan.so.5"], "soname": "prophet.cpython.so", "relocs": 7}
    ).encode()
    ph = w.add_segment(
        code, memsz=len(code) + bss, tail=b"\0" * (bss + gap) + dynamic
    )
    dyn_addr = ph.p_vaddr + ph.p_filesz + bss + gap
    w.add_section("DYNAMIC", PT_DYNAMIC, dyn_addr, dynamic)
    w.add_section("text", PT_LOAD, ph.p_vaddr, code)
    return w.finish()
