"""Device I/P/B decode (device_ipb.py): C++ entropy + motion derivation,
device MC kernel + wavefront recon + device deblocking — bit-exact vs the
libavcodec oracle on motion-compensated sequences."""
import numpy as np
import pytest

from dryv_tpu.decoder import DecodedFrame
from dryv_tpu.device_ipb import decode_annexb_device
from dryv_tpu.encoder import default_sps_pps
from dryv_tpu.encoder.p_frame import SequenceEncoder
from dryv_tpu.encoder.slices import encode_sequence_annexb
from dryv_tpu.testing.oracle import decode_annexb


def _sources(seed, mb_w, mb_h):
    rng = np.random.RandomState(seed)
    W, H = mb_w * 16, mb_h * 16
    base_y = np.clip(np.linspace(25, 225, W)[None, :]
                     + rng.randint(-12, 13, (H, W)), 0, 255).astype(np.int64)
    base_cb = np.clip(105 + rng.randint(-9, 10, (H // 2, W // 2)),
                      0, 255).astype(np.int64)
    base_cr = np.clip(135 + rng.randint(-9, 10, (H // 2, W // 2)),
                      0, 255).astype(np.int64)

    def frame_at(shift):
        y = np.roll(np.roll(base_y, shift, axis=1), shift // 2,
                    axis=0).copy()
        y[18:38, 25 + shift * 2:57 + shift * 2] = 205
        return (y, np.roll(base_cb, shift, axis=1).copy(), base_cr.copy())
    return frame_at


def _check(stream, device_out=False):
    ref = decode_annexb(stream)
    got = decode_annexb_device(stream, device_out=device_out,
                               interpret=True)
    if device_out:
        # (y, cb, cr, poc, sps) device planes, display order, uncropped
        got = [DecodedFrame(np.asarray(y), np.asarray(cb), np.asarray(cr),
                            poc).crop(sps) for y, cb, cr, poc, sps in got]
    got = sorted(got, key=lambda f: f.poc)
    assert len(ref) == len(got)
    for i, ((ry, rcb, rcr), f) in enumerate(zip(ref, got)):
        assert np.array_equal(ry, f.y), f"frame {i} luma"
        assert np.array_equal(rcb, f.cb), f"frame {i} cb"
        assert np.array_equal(rcr, f.cr), f"frame {i} cr"


@pytest.mark.parametrize("deblock", [False, True])
@pytest.mark.parametrize("device_out", [False, True])
def test_device_ipb_sequence(deblock, device_out):
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
    _check(stream, device_out=device_out)


def test_device_ipb_bench_fixture():
    """The 640x368 IPB bench stream (quarter-pel MC, B frames, direct
    modes, in-loop filter) through the device pipeline."""
    import os
    path = os.path.join(os.path.dirname(__file__), "..", "benchdata",
                        "bench_ipb.264")
    g = np.load(os.path.join(os.path.dirname(__file__), "..", "benchdata",
                             "bench_ipb_golden.npz"))
    stream = open(path, "rb").read()
    frames = sorted(decode_annexb_device(stream, interpret=True),
                    key=lambda f: f.poc)
    for i, f in enumerate(frames):
        assert np.array_equal(f.y, g[f"f{i}_y"]), f"frame {i}"
        assert np.array_equal(f.cb, g[f"f{i}_b"])
        assert np.array_equal(f.cr, g[f"f{i}_r"])


def test_device_ipb_weighted_explicit():
    """Explicit WP (P slices): per-block weight resolution on device."""
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


def test_device_ipb_weighted_implicit():
    """Implicit B weights (weighted_bipred_idc 2) on device."""
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


# --- conformance breadth: every third-party stream through the device
# entry point (round-4 review: decode_annexb_device crashed with
# IndexError on MBAFF streams instead of taking the documented fallback;
# the fallback set now mirrors native/full.py's plus field/MBAFF) -------

def _conformance_streams():
    import glob
    import os
    corpus = os.path.join(os.path.dirname(__file__), "conformance")
    return sorted(glob.glob(os.path.join(corpus, "*.264")))


@pytest.mark.parametrize(
    "path", _conformance_streams(),
    ids=[__import__("os").path.basename(p) for p in _conformance_streams()])
def test_device_conformance_bit_exact(path):
    """decode_annexb_device on the whole third-party corpus: device path
    where in scope, documented fallback (native -> scalar) elsewhere —
    never a crash, always bit-exact vs libavcodec."""
    stream = open(path, "rb").read()
    golden = decode_annexb(stream)
    ours = decode_annexb_device(stream, interpret=True)
    assert len(ours) == len(golden), (len(ours), len(golden))
    for i, (o, g) in enumerate(zip(ours, golden)):
        for pn, op, gp in zip(("y", "cb", "cr"), (o.y, o.cb, o.cr), g):
            if gp is None:
                continue
            if op is None:
                assert (gp == 128).all(), f"frame {i} {pn}"
                continue
            assert np.array_equal(np.asarray(op), gp), \
                f"frame {i} plane {pn}"
