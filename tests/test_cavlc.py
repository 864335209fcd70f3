"""CAVLC entropy layer conformance vs the libavcodec oracle.

The upstream reference leaves CAVLC as `todo!()` (slice/mod.rs:299);
intra fixtures are covered by the cavlc_* specs in test_conformance.
Here: symmetric round-trip sanity + inter (P/B/WP/deblock) sequences."""
import numpy as np
import pytest

from dryv_tpu.cabac.syntax import MbKind
from dryv_tpu.decoder import decode_annexb_scalar
from dryv_tpu.encoder import default_sps_pps
from dryv_tpu.encoder.p_frame import SequenceEncoder
from dryv_tpu.encoder.slices import encode_sequence_annexb
from dryv_tpu.testing.oracle import decode_annexb

from tests.test_bframes import _sources


def _check(stream, n):
    oracle = decode_annexb(stream)
    assert len(oracle) == n
    ours = sorted(decode_annexb_scalar(stream), key=lambda f: f.poc)
    for i, (oy, ocb, ocr) in enumerate(oracle):
        assert np.array_equal(oy, ours[i].y), f"frame {i} luma"
        assert np.array_equal(ocb, ours[i].cb), f"frame {i} cb"
        assert np.array_equal(ocr, ours[i].cr), f"frame {i} cr"


def test_cavlc_p_sequence():
    """IDR + 2 P frames: skip runs, partitions, multi-ref, intra escapes."""
    mb_w, mb_h = 6, 4
    frame_at = _sources(101, mb_w, mb_h)
    sps, pps = default_sps_pps(mb_w, mb_h, qp=28, cabac=False, max_refs=2)
    se = SequenceEncoder(sps, pps, 28)
    frames = [(se.encode_idr(*frame_at(0)), 7, True, 0),
              (se.encode_p(*frame_at(1)), 5, False, 1),
              (se.encode_p(*frame_at(3)), 5, False, 2)]
    kinds = {m.kind for m in frames[1][0]} | {m.kind for m in frames[2][0]}
    assert MbKind.P_SKIP in kinds and MbKind.P_8X8 in kinds
    _check(encode_sequence_annexb(sps, pps, frames), 3)


def test_cavlc_b_deblock():
    """IDR + P + B with the in-loop filter: B skip runs, direct, bi."""
    mb_w, mb_h = 6, 4
    frame_at = _sources(103, mb_w, mb_h)
    sps, pps = default_sps_pps(mb_w, mb_h, qp=29, cabac=False, poc_type=0,
                               max_refs=2)
    se = SequenceEncoder(sps, pps, 29, deblock=True)
    frames = [(se.encode_idr(*frame_at(0), poc=0), 7, True, 0, 0, 3),
              (se.encode_p(*frame_at(4), poc=8), 5, False, 1, 8, 3),
              (se.encode_b(*frame_at(2), poc=4), 6, False, 2, 4, 0)]
    _check(encode_sequence_annexb(sps, pps, frames, deblock_disable=0), 3)


def test_cavlc_weighted_temporal():
    """Explicit WP P + temporal-direct B, all CAVLC."""
    from dryv_tpu.avc.slice_header import PredWeight, PredWeightTable
    mb_w, mb_h = 5, 4
    frame_at = _sources(107, mb_w, mb_h)
    sps, pps = default_sps_pps(mb_w, mb_h, qp=28, cabac=False, poc_type=0,
                               max_refs=2, weighted_pred=1)
    se = SequenceEncoder(sps, pps, 28)
    pwt = PredWeightTable(
        luma_log2_weight_denom=5, chroma_log2_weight_denom=6,
        luma_l0=[PredWeight(40, -4), None],
        chroma_l0=[(PredWeight(70, 5), PredWeight(60, -6)), None])
    frames = [
        (se.encode_idr(*frame_at(0), poc=0), 7, True, 0, 0, 3),
        (se.encode_p(*frame_at(2), poc=4, wp_table=pwt), 5, False, 1, 4,
         3, pwt),
        (se.encode_p(*frame_at(4), poc=8, wp_table=pwt,
                     max_search_refs=1), 5, False, 2, 8, 3, pwt),
        (se.encode_b(*frame_at(3), poc=6, temporal=True), 6, False, 3, 6,
         0, None, 0),
    ]
    _check(encode_sequence_annexb(sps, pps, frames), 4)


def test_cavlc_device_path():
    """CAVLC intra streams reconstruct on the JAX device path too (the
    entropy layer is upstream of the shared syntax tensors)."""
    from dryv_tpu.pipeline import decode_annexb_tpu
    from dryv_tpu.testing.fixtures import get_fixture
    stream, (gy, gcb, gcr), sps, pps = get_fixture("cavlc_mix_qp26")
    f = decode_annexb_tpu(stream, interpret=True)[0]
    assert np.array_equal(f.y, gy)
    assert np.array_equal(f.cb, gcb)
    assert np.array_equal(f.cr, gcr)


@pytest.mark.parametrize("name", ["cavlc_mix_qp26", "cavlc_mix8_qp30",
                                  "cavlc_dblk_qp30"])
def test_cavlc_native_full(name):
    """The C++ CAVLC entropy stage + native recon path is bit-exact."""
    from dryv_tpu.native.full import decode_annexb_native
    from dryv_tpu.testing.fixtures import get_fixture
    stream, (gy, gcb, gcr), sps, pps = get_fixture(name)
    f = decode_annexb_native(stream)[0]
    assert np.array_equal(f.y, gy)
    assert np.array_equal(f.cb, gcb)
    assert np.array_equal(f.cr, gcr)


def test_cavlc_native_inter():
    """CAVLC P+B sequence through the C++ path matches the scalar path."""
    from dryv_tpu.native.full import decode_annexb_native
    mb_w, mb_h = 6, 4
    frame_at = _sources(109, mb_w, mb_h)
    sps, pps = default_sps_pps(mb_w, mb_h, qp=29, cabac=False, poc_type=0,
                               max_refs=2)
    se = SequenceEncoder(sps, pps, 29, deblock=True)
    frames = [(se.encode_idr(*frame_at(0), poc=0), 7, True, 0, 0, 3),
              (se.encode_p(*frame_at(4), poc=8), 5, False, 1, 8, 3),
              (se.encode_b(*frame_at(2), poc=4), 6, False, 2, 4, 0)]
    stream = encode_sequence_annexb(sps, pps, frames, deblock_disable=0)
    ref = sorted(decode_annexb_scalar(stream), key=lambda f: f.poc)
    ours = sorted(decode_annexb_native(stream), key=lambda f: f.poc)
    for i, (a, b) in enumerate(zip(ours, ref)):
        assert np.array_equal(np.asarray(a.y), np.asarray(b.y)), f"fr {i}"
        assert np.array_equal(np.asarray(a.cb), np.asarray(b.cb)), f"fr {i}"
