"""Gofer — mediated filesystem access for the sandbox (paper §III.A).

gVisor's Gofer brokers all filesystem access over 9P so the Sentry never
opens host files directly.  Our Gofer plays the same role for the engine's
object store: sandboxed code and the checkpoint subsystem perform I/O only
through a :class:`Gofer` holding explicit path **capabilities** (root +
mode).  Nothing here is a metaphor: the checkpoint manager takes a Gofer,
not a path, so a sandbox escape cannot reach host state the capability does
not name.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List

__all__ = ["Capability", "CapabilityError", "Gofer"]


class CapabilityError(PermissionError):
    pass


@dataclass(frozen=True)
class Capability:
    root: Path
    read: bool = True
    write: bool = False

    def check(self, path: Path, *, want_write: bool) -> Path:
        resolved = (self.root / path).resolve()
        root = self.root.resolve()
        if not str(resolved).startswith(str(root) + os.sep) and resolved != root:
            raise CapabilityError(f"{path} escapes capability root {root}")
        if want_write and not self.write:
            raise CapabilityError(f"capability on {root} is read-only")
        if not want_write and not self.read:
            raise CapabilityError(f"capability on {root} is write-only")
        return resolved


class Gofer:
    """Capability-checked file broker."""

    def __init__(self, capabilities: Dict[str, Capability]) -> None:
        self._caps = dict(capabilities)
        self.ops: List[str] = []  # audit log

    @classmethod
    def for_root(cls, name: str, root: str | Path, *, write: bool = False) -> "Gofer":
        root = Path(root)
        root.mkdir(parents=True, exist_ok=True)
        return cls({name: Capability(root, read=True, write=write)})

    def _cap(self, name: str) -> Capability:
        try:
            return self._caps[name]
        except KeyError:
            raise CapabilityError(f"no capability named {name!r}") from None

    def read_bytes(self, cap: str, rel: str | Path) -> bytes:
        p = self._cap(cap).check(Path(rel), want_write=False)
        self.ops.append(f"read {cap}:{rel}")
        return p.read_bytes()

    def write_bytes(self, cap: str, rel: str | Path, data: bytes) -> None:
        p = self._cap(cap).check(Path(rel), want_write=True)
        p.parent.mkdir(parents=True, exist_ok=True)
        tmp = p.with_suffix(p.suffix + ".tmp")
        tmp.write_bytes(data)
        os.replace(tmp, p)  # atomic publish
        self.ops.append(f"write {cap}:{rel} ({len(data)}B)")

    def exists(self, cap: str, rel: str | Path) -> bool:
        try:
            p = self._cap(cap).check(Path(rel), want_write=False)
        except CapabilityError:
            raise
        return p.exists()

    def listdir(self, cap: str, rel: str | Path = ".") -> List[str]:
        p = self._cap(cap).check(Path(rel), want_write=False)
        self.ops.append(f"list {cap}:{rel}")
        return sorted(os.listdir(p)) if p.exists() else []

    def delete(self, cap: str, rel: str | Path) -> None:
        p = self._cap(cap).check(Path(rel), want_write=True)
        if p.exists():
            p.unlink()
        self.ops.append(f"delete {cap}:{rel}")
