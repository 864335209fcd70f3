"""The wire-ABI coefficient unpack (kernels/densify.py) against a numpy
encoder/decoder of the same format: bitmap + int8 values, |v| > 127
exceptions and whole-row overflow for MBs with more than W nonzeros."""
import numpy as np
import pytest

L = 408


def _encode(dense, W, ecap, ovcap):
    """numpy reference encoder of one frame's dense [npad, 408] rows."""
    npad = dense.shape[0]
    bmp = np.zeros((npad, 51), np.uint8)
    vals = np.zeros((npad, W), np.int8)
    exc_idx = np.zeros(ecap, np.int32)
    exc_delta = np.zeros(ecap, np.int16)
    ovf_idx = np.full(ovcap, npad, np.int32)
    ovf_rows = np.zeros((ovcap, L), np.int16)
    ne = no = 0
    for r in range(npad):
        nz = np.flatnonzero(dense[r])
        for c in nz:
            bmp[r, c >> 3] |= 1 << (c & 7)
        if len(nz) > W:
            ovf_idx[no] = r
            ovf_rows[no] = dense[r]
            no += 1
            continue
        for k, c in enumerate(nz):
            v = int(dense[r, c])
            clipped = max(-127, min(127, v))
            vals[r, k] = clipped
            if clipped != v:
                exc_idx[ne] = r * L + c
                exc_delta[ne] = v - clipped
                ne += 1
    return bmp, vals, exc_idx, exc_delta, ovf_idx, ovf_rows


def _densify_ref(bmp, vals):
    """numpy reference of densify alone (no exception/overflow fixes)."""
    npad, W = vals.shape
    out = np.zeros((npad, L), np.int16)
    for r in range(npad):
        k = 0
        for c in range(L):
            if (bmp[r, c >> 3] >> (c & 7)) & 1:
                k += 1
                if k <= W:
                    out[r, c] = vals[r, k - 1]
    return out


@pytest.mark.parametrize("seed,W,density,big", [
    (0, 32, 0.05, False),     # sparse rows, empty rows
    (1, 32, 0.2, True),       # rows over W nonzeros -> overflow channel
    (2, 96, 0.15, True),      # |v| > 127 -> exception channel
    (3, 8, 0.5, True),        # most rows overflow
    (4, 64, 0.0, False),      # an all-zero frame
])
def test_unpack_coeffs_matches_numpy(seed, W, density, big):
    from dryv_tpu.kernels.densify import densify, unpack_coeffs

    rng = np.random.default_rng(seed)
    npad = 24
    dense = np.zeros((npad, L), np.int16)
    mask = rng.random((npad, L)) < density
    mask[::5] = False                              # empty rows
    lim = 2000 if big else 127
    v = rng.integers(-lim, lim + 1, (npad, L))
    v[v == 0] = 1
    dense[mask] = v[mask]
    bmp, vals, ei, ed, oi, orows = _encode(dense, W, ecap=4096, ovcap=npad)
    assert np.array_equal(np.asarray(densify(bmp, vals)),
                          _densify_ref(bmp, vals))
    got = np.asarray(unpack_coeffs(bmp, vals, ei, ed, oi, orows))
    assert got.dtype == np.int16
    assert np.array_equal(got, dense)
