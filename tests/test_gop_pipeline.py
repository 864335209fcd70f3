"""Batched pipelined GOP decode (gop_pipeline.py) vs the libavcodec
oracle: distinct frames per batch, tail-batch padding, deblocked and
non-deblocked streams, and the fallback for out-of-scope streams."""
import numpy as np
import pytest

from dryv_tpu.testing.oracle import decode_annexb
from dryv_tpu.testing.x264 import encode_x264


def _frames(n, w=64, h=48, seed=3):
    rng = np.random.default_rng(seed)
    base_y = np.clip(np.linspace(30, 220, w)[None, :]
                     + rng.integers(-20, 20, (h, w)), 0, 255).astype(np.uint8)
    base_c = np.clip(128 + rng.integers(-30, 30, (h // 2, w // 2)),
                     0, 255).astype(np.uint8)
    out = []
    for t in range(n):
        out.append((np.roll(base_y, 3 * t, axis=1),
                    np.roll(base_c, t, axis=1),
                    np.roll(base_c, -t, axis=0)))
    return out


@pytest.mark.parametrize("params", ["qp=30:keyint=1:slices=2",
                                    "qp=34:keyint=1:nf=1"])
def test_gop_pipelined_oracle(params):
    from dryv_tpu.gop_pipeline import decode_annexb_gop_pipelined

    stream = encode_x264(_frames(6), x264_params=params)
    ref = decode_annexb(stream)
    got = decode_annexb_gop_pipelined(stream, gop=4, n_threads=1,
                                      interpret=True)
    assert len(got) == len(ref) == 6
    for f, (ry, rcb, rcr) in zip(got, ref):
        assert np.array_equal(f.y, ry)
        assert np.array_equal(f.cb, rcb)
        assert np.array_equal(f.cr, rcr)


def test_gop_pipelined_device_out():
    from dryv_tpu.gop_pipeline import decode_annexb_gop_pipelined

    stream = encode_x264(_frames(3), x264_params="qp=30:keyint=1:nf=1")
    ref = decode_annexb(stream)
    got = decode_annexb_gop_pipelined(stream, gop=2, n_threads=1,
                                      device_out=True, interpret=True)
    assert len(got) == 3
    for (y, cb, cr), (ry, rcb, rcr) in zip(got, ref):
        H, W = ry.shape
        assert np.array_equal(np.asarray(y)[:H, :W], ry)
        assert np.array_equal(np.asarray(cb)[:H // 2, :W // 2], rcb)


def test_gop_pipelined_fallback_inter():
    """P-frame streams fall back to the per-picture native path."""
    from dryv_tpu.gop_pipeline import decode_annexb_gop_pipelined

    stream = encode_x264(_frames(4), x264_params="qp=30:keyint=2:bframes=0:"
                                                 "scenecut=0:min-keyint=2")
    ref = decode_annexb(stream)
    got = decode_annexb_gop_pipelined(stream, gop=4, n_threads=1,
                                      interpret=True)
    assert len(got) == len(ref)
    for f, (ry, rcb, rcr) in zip(got, ref):
        assert np.array_equal(f.y, ry)
        assert np.array_equal(f.cb, rcb)
