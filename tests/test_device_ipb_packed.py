"""Packed-wire device I/P/B decode (device_ipb_packed.py): bitmap
coefficient ABI + compact motion field + on-device WP resolve and inter
deblock precompute — bit-exact vs the libavcodec oracle."""
import numpy as np
import pytest

from dryv_tpu.device_ipb_packed import decode_annexb_device_packed
from dryv_tpu.encoder import default_sps_pps
from dryv_tpu.encoder.p_frame import SequenceEncoder
from dryv_tpu.encoder.slices import encode_sequence_annexb
from dryv_tpu.testing.oracle import decode_annexb

from test_device_ipb import _sources


def _check(stream):
    ref = decode_annexb(stream)
    got = sorted(decode_annexb_device_packed(stream, interpret=True),
                 key=lambda f: f.poc)
    assert len(ref) == len(got)
    for i, ((ry, rcb, rcr), f) in enumerate(zip(ref, got)):
        assert np.array_equal(ry, f.y), f"frame {i} luma"
        assert np.array_equal(rcb, f.cb), f"frame {i} cb"
        assert np.array_equal(rcr, f.cr), f"frame {i} cr"


@pytest.mark.parametrize("deblock", [False, True])
def test_packed_ipb_sequence(deblock):
    mb_w, mb_h = 6, 4
    frame_at = _sources(31, mb_w, mb_h)
    sps, pps = default_sps_pps(mb_w, mb_h, qp=28, poc_type=0, max_refs=2)
    se = SequenceEncoder(sps, pps, 28, deblock=deblock)
    frames = [
        (se.encode_idr(*frame_at(0), poc=0), 7, True, 0, 0, 3),
        (se.encode_p(*frame_at(4), poc=8), 5, False, 1, 8, 3),
        (se.encode_b(*frame_at(2), poc=4), 6, False, 2, 4, 0),
    ]
    stream = encode_sequence_annexb(sps, pps, frames,
                                    deblock_disable=0 if deblock else 1)
    _check(stream)


def test_packed_ipb_weighted_explicit():
    from dryv_tpu.avc.slice_header import PredWeight, PredWeightTable

    mb_w, mb_h = 5, 4
    frame_at = _sources(41, mb_w, mb_h)
    sps, pps = default_sps_pps(mb_w, mb_h, qp=28, weighted_pred=1)
    se = SequenceEncoder(sps, pps, 28)
    pwt = PredWeightTable(
        luma_log2_weight_denom=5,
        chroma_log2_weight_denom=6,
        luma_l0=[PredWeight(40, -4)],
        chroma_l0=[(PredWeight(70, 5), PredWeight(60, -6))])
    frames = [
        (se.encode_idr(*frame_at(0)), 7, True, 0),
        (se.encode_p(*frame_at(1), wp_table=pwt), 5, False, 1, 0, 3, pwt),
        (se.encode_p(*frame_at(3), wp_table=pwt), 5, False, 2, 0, 3, pwt),
    ]
    stream = encode_sequence_annexb(sps, pps, frames)
    _check(stream)


def test_packed_ipb_weighted_implicit():
    mb_w, mb_h = 5, 4
    frame_at = _sources(47, mb_w, mb_h)
    sps, pps = default_sps_pps(mb_w, mb_h, qp=28, poc_type=0, max_refs=2,
                               weighted_bipred_idc=2)
    se = SequenceEncoder(sps, pps, 28)
    frames = [
        (se.encode_idr(*frame_at(0), poc=0), 7, True, 0, 0, 3),
        (se.encode_p(*frame_at(4), poc=8), 5, False, 1, 8, 3),
        (se.encode_b(*frame_at(1), poc=2), 6, False, 2, 2, 0),
    ]
    stream = encode_sequence_annexb(sps, pps, frames)
    _check(stream)


def test_packed_ipb_bench_fixture():
    """The 640x368 IPB bench stream (quarter-pel MC, B frames, direct
    modes, in-loop filter) through the packed device pipeline."""
    import os
    path = os.path.join(os.path.dirname(__file__), "..", "benchdata",
                        "bench_ipb.264")
    g = np.load(os.path.join(os.path.dirname(__file__), "..", "benchdata",
                             "bench_ipb_golden.npz"))
    stream = open(path, "rb").read()
    frames = sorted(decode_annexb_device_packed(stream, interpret=True),
                    key=lambda f: f.poc)
    for i, f in enumerate(frames):
        assert np.array_equal(f.y, g[f"f{i}_y"]), f"frame {i}"
        assert np.array_equal(f.cb, g[f"f{i}_b"])
        assert np.array_equal(f.cr, g[f"f{i}_r"])
