"""Build native sources into shared libraries at first use.

Each library is keyed on a hash of its sources and compiler command, built
into this package's own `build/` directory (listed in .gitignore) under a
temporary name and moved into place with an atomic rename, so concurrent
processes never load a half-written file and never race on one output.
"""
from __future__ import annotations

import hashlib
import os
import pathlib
import subprocess

PKG_ROOT = pathlib.Path(__file__).resolve().parents[1]
BUILD_DIR = PKG_ROOT / "build"


def build_shared(name: str, sources, command,
                 deps=()) -> tuple[pathlib.Path, str]:
    """Compile `sources` with `command` (compiler and flags, without the
    sources and `-o`) into BUILD_DIR/lib{name}-{hash}.so.  `deps` are
    files the build reads without naming them as sources (headers); they
    are hashed too.

    Returns (path, compiler output); the output is empty when the library
    was already built."""
    h = hashlib.sha256()
    for part in command:
        h.update(part.encode() + b"\0")
    for src in (*sources, *deps):
        h.update(pathlib.Path(src).read_bytes())
    out = BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"
    if out.exists():
        return out, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.tmp{os.getpid()}")
    try:
        proc = subprocess.run(
            [*command, *map(str, sources), "-o", str(tmp)],
            capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"building {name} failed ({command[0]} exit "
                f"{proc.returncode}):\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)
    finally:
        tmp.unlink(missing_ok=True)
    return out, proc.stdout + proc.stderr
