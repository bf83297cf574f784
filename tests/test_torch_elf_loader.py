"""The port's SELF writer and image loader against the reference's.

``repro_torch.core.elf`` and ``repro_torch.core.loader`` are copies of the
reference's pure-Python modules; these tests hold them to it byte for
byte: the same writer calls give the same image, both loaders map it to
the same memory under Linux and legacy semantics with equal
``ZeroStats``, and a section a loader corrupts raises ``SegfaultError`` in
both.  The segment layouts are drawn from seeded generators (``hypothesis``
is not installed here).  Everything is exact: no tolerance.
"""

import json

import numpy as np
import pytest

from repro.core import elf as ref_elf
from repro.core import loader as ref_loader
from repro_torch.core import elf, loader

SEEDS = range(24)


def _layout(seed):
    """A random writer script: segments with zero-fill tails (some past
    the last file page) and, on some, a section placed after ``memsz`` but
    inside the page-aligned extension of ``filesz`` — outside every LOAD,
    on the file page that maps with the segment: the paper's Fig. 4
    class."""
    rng = np.random.default_rng(seed)
    ops = []
    for i in range(int(rng.integers(1, 6))):
        data = rng.integers(0, 256, int(rng.integers(1, 9000))).astype(
            np.uint8).tobytes()
        payload = json.dumps({"seg": i, "seed": seed}).encode()
        room = (-len(data)) % elf.PAGE_SIZE - len(payload)
        if room > 0 and rng.random() < 0.6:
            bss = int(rng.integers(0, room))
            gap = int(rng.integers(0, room - bss))
            ops.append((data, len(data) + bss,
                        b"\0" * (bss + gap) + payload, True))
        else:
            bss = int(rng.choice([0, 1, 7, 100, 3000, 5000]))
            ops.append((data, len(data) + bss, b"", False))
    return ops


def _write(mod, ops):
    w = mod.SELFWriter()
    for i, (data, memsz, tail, section) in enumerate(ops):
        ph = w.add_segment(data, memsz=memsz, tail=tail)
        if section:
            payload = tail.lstrip(b"\0")
            w.add_section(f"dyn{i}", mod.PT_DYNAMIC,
                          ph.p_vaddr + len(data) + len(tail) - len(payload),
                          payload)
        w.add_section(f"text{i}", mod.PT_LOAD, ph.p_vaddr, data)
    return w.finish()


def _load(mod, blob, semantics):
    """(memory bytes, base address, zero stats, the error that
    verification raised or None) of one load."""
    img = mod.ImageLoader(semantics).load(blob, verify=False)
    try:
        img.verify_all()
        err = None
    except mod.SegfaultError as e:
        err = type(e).__name__
    stats = (img.zero_stats.prescribed, img.zero_stats.page_extension)
    return bytes(img.memory), img.base, stats, err


@pytest.mark.parametrize("seed", SEEDS)
def test_writer_blobs_are_byte_identical(seed):
    ops = _layout(seed)
    blob = _write(elf, ops)
    assert blob == _write(ref_elf, ops)
    ours, theirs = elf.read_self(blob), ref_elf.read_self(blob)
    assert [p.__dict__ for p in ours.phdrs] == \
        [p.__dict__ for p in theirs.phdrs]
    assert [s.__dict__ for s in ours.sections] == \
        [s.__dict__ for s in theirs.sections]


@pytest.mark.parametrize("semantics", ["linux", "legacy"])
@pytest.mark.parametrize("seed", SEEDS)
def test_loaded_images_and_zero_stats_match(seed, semantics):
    blob = _write(elf, _layout(seed))
    got = _load(loader, blob, semantics)
    want = _load(ref_loader, blob, semantics)
    assert got == want
    if semantics == "linux":
        assert got[3] is None            # the fix never corrupts a section


def test_some_layouts_break_only_under_legacy():
    """The seeded layouts exercise the pathology: under legacy semantics
    some of them lose a section, under Linux semantics none does."""
    broken = [_load(loader, _write(elf, _layout(s)), "legacy")[3]
              for s in SEEDS]
    assert "SegfaultError" in broken and None in broken


@pytest.mark.parametrize("mod,ld", [(elf, loader), (ref_elf, ref_loader)])
def test_prophet_pathology_raises_under_legacy(mod, ld):
    blob = mod.build_prophet_like()
    assert blob == ref_elf.build_prophet_like()
    ld.ImageLoader("linux").load(blob).verify_section("DYNAMIC")
    with pytest.raises(ld.SegfaultError):
        ld.ImageLoader("legacy").load(blob)


def test_zero_stats_count_the_prescribed_and_the_extension():
    w = elf.SELFWriter()
    w.add_segment(b"x" * 100, memsz=300)
    img = loader.ImageLoader("legacy").load(w.finish())
    assert img.zero_stats == loader.ZeroStats(prescribed=200,
                                              page_extension=4096 - 300)


def test_bad_images_are_refused():
    with pytest.raises(elf.BadImageError):
        elf.read_self(b"NOPE" + bytes(64))
    with pytest.raises(elf.BadImageError):
        elf.ProgramHeader(elf.PT_LOAD, 0, 1, 2, 0, 0)   # page congruence
    with pytest.raises(elf.BadImageError):
        elf.SELFWriter().add_segment(b"abc", memsz=2)
    with pytest.raises(ValueError):
        loader.ImageLoader("solaris")


def test_core_exports_the_loader():
    from repro_torch import core

    assert core.ImageLoader is loader.ImageLoader
    assert core.SegfaultError is loader.SegfaultError
    assert core.SELFWriter is elf.SELFWriter
