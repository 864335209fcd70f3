"""Third-party bitstream conformance: x264-encoded streams (generated by
tools/gen_thirdparty_corpus.py, committed under tests/conformance/) decode
bit-exactly vs the libavcodec oracle on the native host path (which falls
back to the scalar refimpl for features outside its native scope).

This breaks the encoder circularity flagged in round 1: every other
fixture is produced by this repo's own encoder; these streams carry real
encoder behavior — rate-control level sequences, B-pyramids, trailing
non-ref Bs (display reordering), multi-slice inter pictures, weighted
prediction, custom quant matrices, lossless DPCM, HRD/filler NALs,
intra-refresh, open GOPs.  The upstream reference has no conformance
corpus at all (SURVEY.md §4).
"""
import glob
import os

import numpy as np
import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
CORPUS = os.path.join(HERE, "conformance")

# decode gaps still open (tracked in ROADMAP.md); empty since the
# round-3 MBAFF inter reconstruction + MBAFF deblocking landed
XFAIL = {}

STREAMS = sorted(glob.glob(os.path.join(CORPUS, "*.264")))


def _names():
    out = []
    for p in STREAMS:
        n = os.path.splitext(os.path.basename(p))[0]
        out.append(pytest.param(p, id=n, marks=pytest.mark.xfail(
            reason=XFAIL[n]) if n in XFAIL else ()))
    return out


def test_corpus_size():
    # round-1 review: "a conformance directory of >=20 non-self-encoded
    # streams"
    assert len(STREAMS) >= 20, f"only {len(STREAMS)} corpus streams"


@pytest.mark.parametrize("path", _names())
def test_thirdparty_bit_exact(path):
    from dryv_tpu.native.full import decode_annexb_native
    from dryv_tpu.testing.oracle import decode_annexb

    stream = open(path, "rb").read()
    golden = decode_annexb(stream)
    ours = decode_annexb_native(stream)
    assert len(ours) == len(golden), (len(ours), len(golden))
    for i, (o, g) in enumerate(zip(ours, golden)):
        for pn, op, gp in zip(("y", "cb", "cr"), (o.y, o.cb, o.cr), g):
            if gp is None:
                continue
            if op is None:
                # monochrome: libavcodec synthesizes constant mid-gray
                # chroma planes; our decoder reports no chroma
                assert (gp == 128).all(), f"frame {i} {pn}"
                continue
            assert np.array_equal(np.asarray(op), gp), \
                f"frame {i} plane {pn}: {np.sum(np.asarray(op) != gp)} px"


@pytest.mark.parametrize("name", ["defaults_qp28", "slices4",
                                  "lossless_intra", "scenecut"])
def test_thirdparty_scalar_spot(name):
    """Scalar-path spot check (the native test above may route through
    C++; these four always exercise the pure-Python reference)."""
    from dryv_tpu.decoder import decode_annexb_scalar
    from dryv_tpu.testing.oracle import decode_annexb

    stream = open(os.path.join(CORPUS, f"{name}.264"), "rb").read()
    golden = decode_annexb(stream)
    ours = decode_annexb_scalar(stream)
    assert len(ours) == len(golden)
    for o, g in zip(ours, golden):
        for op, gp in zip((o.y, o.cb, o.cr), g):
            if gp is not None and op is not None:
                assert np.array_equal(np.asarray(op), gp)
