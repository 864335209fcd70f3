"""chip_smoke.py's phases rehearsed on the CPU: the same functions the
chip run calls, on small streams, with the wavefront kernel in interpret
mode and the GPU gate left out."""
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

import chip_smoke as cs

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def stream():
    """5 intra pictures, 2 slices each, in-loop filter off (the sharded
    paths reconstruct without it)."""
    from dryv_tpu.testing.x264 import encode_x264
    from test_gop_pipeline import _frames
    return encode_x264(_frames(5), x264_params="qp=30:keyint=1:slices=2:nf=1")


def test_phase_cli(stream, tmp_path, monkeypatch):
    from dryv_tpu.utils import compile_cache
    # keep the CLI's compile cache out of the checkout
    monkeypatch.setenv(compile_cache.ENV, str(tmp_path / "cache"))
    cs.phase_cli(stream, 5, str(tmp_path), interpret=True)


def test_phase_gop(stream):
    cs.phase_gop(stream, 4, platform="cpu", interpret=True)


def test_phase_goldens():
    from dryv_tpu.testing.fixtures import get_fixture
    cases = []
    for name in ("mix_qp26", "dblk_mix_qp26"):
        s, golden, _, _ = get_fixture(name)
        cases.append((name, s, golden))
    cs.phase_goldens(cases, interpret=True)


def test_phase_ipb():
    ipb = cs.read("bench_ipb.264")
    cs.phase_ipb(ipb, ipb, np.load(os.path.join(cs.BENCH,
                                                "bench_ipb_golden.npz")),
                 interpret=True)


def test_phase_wavefront_and_memory(stream):
    t = cs.phase_wavefront(stream, 4, 2, interpret=True)
    assert set(t) == {"kernel_ms", "xla_scan_ms"}
    cs.phase_memory(stream, 4, interpret=True)


def test_phase_multi(stream):
    cs.phase_multi(stream, 4, interpret=True)


@pytest.mark.parametrize("alone", [False, True])
def test_no_result_without_gpu(tmp_path, alone):
    """Without a GPU, or without the rest of the repository, the script
    fails and prints no result line."""
    script = os.path.join(ROOT, "chip_smoke.py")
    if alone:
        shutil.copy(script, tmp_path / "chip_smoke.py")
        script = str(tmp_path / "chip_smoke.py")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, script], capture_output=True,
                       text=True, cwd=tmp_path, env=env, timeout=300)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
