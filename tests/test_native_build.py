"""The native library builds from the committed sources only: its name is
keyed by a content hash of every source and header, a fresh checkout
builds it, and the compiler's output is renamed into place atomically."""
import shutil
import subprocess

import pytest

from dryv_tpu.native import build as nb


@pytest.fixture
def tree(tmp_path, monkeypatch):
    """A private copy of the native sources with the build module pointed
    at it."""
    for p in nb.DEPS:
        shutil.copy(p, tmp_path / p.name)
    monkeypatch.setattr(nb, "HERE", tmp_path)
    monkeypatch.setattr(nb, "SRCS", [tmp_path / p.name for p in nb.SRCS])
    monkeypatch.setattr(nb, "DEPS", [tmp_path / p.name for p in nb.DEPS])
    monkeypatch.setattr(nb, "OUT_DIR", tmp_path / "_build")
    return tmp_path


@pytest.mark.parametrize("dep", [p.name for p in nb.DEPS])
def test_key_tracks_every_source_and_header(tree, dep):
    before = nb.source_key()
    with open(tree / dep, "a") as f:
        f.write("\n// edited\n")
    assert nb.source_key() != before


def test_fresh_checkout_builds_then_reuses(tree, monkeypatch):
    calls = []

    def fake_compiler(cmd, **kw):
        if cmd[0] == "g++" and "-o" in cmd:
            calls.append(cmd)
            with open(cmd[cmd.index("-o") + 1], "w") as f:
                f.write("lib")
            return subprocess.CompletedProcess(cmd, 0)
        return real_run(cmd, **kw)

    real_run = subprocess.run
    monkeypatch.setattr(nb.subprocess, "run", fake_compiler)
    lib = nb.build()
    assert lib.exists() and lib.parent == tree / "_build"
    assert lib.name == f"libdryv_entropy-{nb.source_key()}.so"
    assert nb.build() == lib and len(calls) == 1      # cached by key
    with open(tree / "cavlc_tables.h", "a") as f:
        f.write("\n// edited\n")
    lib2 = nb.build()
    assert lib2 != lib and len(calls) == 2            # header edit rebuilds
    # only finished libraries are left: no temp files from the compiler
    assert sorted(p.name for p in (tree / "_build").iterdir()) == \
        sorted([lib.name, lib2.name])


def test_build_dir_is_ignored_by_git():
    import os
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, ".gitignore")) as f:
        ignored = f.read().split()
    assert "dryv_tpu/native/_build/" in ignored
    r = subprocess.run(["git", "ls-files", "dryv_tpu/native"], cwd=root,
                       capture_output=True, text=True)
    assert r.returncode != 0 or not any(
        n.endswith(".so") for n in r.stdout.split())
