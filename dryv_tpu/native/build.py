"""Build the native entropy library with g++ (no external deps).

The library is built from the committed sources into ``_build/`` (listed
in .gitignore), under a name keyed by a content hash of every source and
header, the compiler flags and the instruction set g++ targets on this
host (``-march=native``).  A fresh
checkout therefore builds on first use, an edited source or header
rebuilds, and a stale or foreign binary is never loaded.  The compiler
writes to a private temp file that is renamed into place, so concurrent
processes (pytest-xdist workers) never load a half-written library.
"""
from __future__ import annotations

import hashlib
import os
import subprocess
import tempfile
from pathlib import Path

HERE = Path(__file__).resolve().parent
SRCS = [HERE / "entropy.cc", HERE / "recon.cc", HERE / "deblock.cc"]
DEPS = SRCS + [HERE / "tables_data.h", HERE / "cavlc_tables.h"]
OUT_DIR = HERE / "_build"
FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17", "-pthread",
         "-march=native"]


def _native_target() -> bytes:
    """g++'s predefined macros for this host's -march=native (ISA
    extensions such as __AVX2__ select code paths in entropy.cc)."""
    return subprocess.run(
        ["g++", "-march=native", "-E", "-dM", "-x", "c++", os.devnull],
        check=True, capture_output=True).stdout


def source_key() -> str:
    """Content hash of the sources, headers, flags and target ISA."""
    h = hashlib.sha256()
    for p in DEPS:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(FLAGS).encode())
    h.update(_native_target())
    return h.hexdigest()[:16]


def lib_path() -> Path:
    return OUT_DIR / f"libdryv_entropy-{source_key()}.so"


def build(force: bool = False) -> Path:
    lib = lib_path()
    if lib.exists() and not force:
        return lib
    OUT_DIR.mkdir(exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=OUT_DIR)
    os.close(fd)
    try:
        subprocess.run(["g++", *FLAGS, *map(str, SRCS), "-o", tmp],
                       check=True, cwd=HERE)
        os.replace(tmp, lib)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return lib


if __name__ == "__main__":
    print(build(force=True))
