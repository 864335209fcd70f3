"""Device-side deblocking (kernels/deblock.py): the full fast path
(C++ entropy -> device wavefront recon -> device wavefront deblock) must
be bit-exact vs the libavcodec goldens on every deblocked intra fixture.
"""
import numpy as np
import pytest

from dryv_tpu.pipeline import decode_annexb_fast
from dryv_tpu.testing.fixtures import get_fixture

DBLK_420 = ["dblk_i16_qp30", "dblk_i16_qp31", "dblk_i4_qp33",
            "dblk_i16_qp40", "dblk_i4_qp45", "dblk_mix_qp26",
            "dblk_i8_qp32", "dblk_slices_qp28"]


@pytest.mark.parametrize("name", DBLK_420)
def test_device_deblock_bit_exact(name):
    stream, (y, cb, cr), sps, pps = get_fixture(name)
    f = decode_annexb_fast(stream, interpret=True)[0]
    assert np.array_equal(f.y, y)
    assert np.array_equal(f.cb, cb)
    assert np.array_equal(f.cr, cr)


def test_device_deblock_non_dblk_unchanged():
    # a stream with the filter disabled must not change behavior
    stream, (y, cb, cr), sps, pps = get_fixture("mix_qp26")
    f = decode_annexb_fast(stream, interpret=True)[0]
    assert np.array_equal(f.y, y)
    assert np.array_equal(f.cb, cb)
    assert np.array_equal(f.cr, cr)
