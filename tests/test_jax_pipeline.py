"""Bit-exactness of the JAX (stage A + wavefront) reconstruction pipeline.

A subset of fixture configs keeps CI fast (each geometry pays one XLA
compile); the full sweep runs in tools/run_full_conformance.py.
"""
import numpy as np
import pytest

from dryv_tpu.pipeline import decode_annexb_tpu
from dryv_tpu.testing.fixtures import get_fixture

SUBSET = ["mix_qp26", "mix8_qp30", "slices_qp28", "scal_mix8_qp28"]


@pytest.mark.parametrize("name", SUBSET)
def test_jax_decode_bit_exact(name):
    stream, (gy, gcb, gcr), sps, pps = get_fixture(name)
    frame = decode_annexb_tpu(stream, interpret=True)[0]
    assert np.array_equal(frame.y, gy), f"{name}: luma mismatch"
    assert np.array_equal(frame.cb, gcb), f"{name}: cb mismatch"
    assert np.array_equal(frame.cr, gcr), f"{name}: cr mismatch"


@pytest.mark.parametrize("name", ["dblk_mix_qp26", "dblk_i8_qp32",
                                  "dblk_slices_qp28"])
def test_fast_path_deblock_bit_exact(name):
    """decode_annexb_fast keeps deblocking-enabled intra streams on the
    C++ entropy + device recon + C++ deblock path (no scalar fallback)."""
    from dryv_tpu.pipeline import decode_annexb_fast
    stream, (gy, gcb, gcr), sps, pps = get_fixture(name)
    frame = decode_annexb_fast(stream, interpret=True)[0]
    assert np.array_equal(frame.y, gy), f"{name}: luma mismatch"
    assert np.array_equal(frame.cb, gcb), f"{name}: cb mismatch"
    assert np.array_equal(frame.cr, gcr), f"{name}: cr mismatch"


@pytest.mark.parametrize("name", ["scal_mix8_qp28", "scal_pps_qp30",
                                  "scal_dblk_qp32"])
def test_fast_path_scaling_matrices(name):
    """Custom SPS/PPS scaling matrices feed per-list LevelScale tables to
    the device dequant (flat tables would decode these wrong)."""
    from dryv_tpu.pipeline import decode_annexb_fast
    stream, (gy, gcb, gcr), sps, pps = get_fixture(name)
    frame = decode_annexb_fast(stream, interpret=True)[0]
    assert np.array_equal(frame.y, gy), f"{name}: luma mismatch"
    assert np.array_equal(frame.cb, gcb), f"{name}: cb mismatch"
    assert np.array_equal(frame.cr, gcr), f"{name}: cr mismatch"


def test_scaling_list_roundtrip():
    """SPS/PPS scaling-list write -> parse preserves the resolved lists."""
    from dryv_tpu.avc import SPS, PPS
    stream, _, sps, pps = get_fixture("scal_mix8_qp28")
    sps2 = SPS.parse(sps.write())
    assert sps2.seq_scaling_matrix_present_flag
    assert np.array_equal(sps2.seq_scaling_lists.l4x4,
                          sps.seq_scaling_lists.l4x4)
    assert np.array_equal(sps2.seq_scaling_lists.l8x8[:2],
                          sps.seq_scaling_lists.l8x8[:2])
    _, _, sps3, pps3 = get_fixture("scal_pps_qp30")
    pps4 = PPS.parse(pps3.write(), sps3)
    assert pps4.pic_scaling_matrix_present_flag
    assert np.array_equal(pps4.pic_scaling_lists.l4x4,
                          pps3.pic_scaling_lists.l4x4)


def test_lane_major_stage_a_matches_reference():
    """The lane-major (16,B) stage A (augmented-matmul IDCTs) is
    bit-identical to the block-major reference implementation across the
    conformance envelope (levels bounded so dequantized coefficients stay
    within the spec's 16-bit intermediate guarantee, 8.5.12.1)."""
    import jax.numpy as jnp
    from dryv_tpu.kernels import transform as T

    rng = np.random.default_rng(5)
    J = jnp.asarray
    n = 400
    qp = J(rng.integers(0, 52, n).astype(np.int32))
    luma4 = J(rng.integers(-64, 64, (n, 16, 4, 4)).astype(np.int32))
    luma8 = J(rng.integers(-64, 64, (n, 4, 8, 8)).astype(np.int32))
    luma_dc = J(rng.integers(-64, 64, (n, 4, 4)).astype(np.int32))
    cdc = J(rng.integers(-64, 64, (n, 2, 2, 2)).astype(np.int32))
    cac = J(rng.integers(-64, 64, (n, 2, 4, 4, 4)).astype(np.int32))
    kind = J(rng.integers(0, 3, n).astype(np.int32))
    ls4 = J(T.LS4_FLAT)
    ls8 = J(T.LS8_FLAT)
    a = T.luma_residual_tiles_ref(kind, qp, luma4, luma8, luma_dc, n,
                                  ls4, ls8)
    b = T.luma_residual_tiles(kind, qp, luma4, luma8, luma_dc, n, ls4, ls8)
    assert np.array_equal(np.asarray(a), np.asarray(b))
    qpc = J(rng.integers(0, 52, n).astype(np.int32))
    qpr = J(rng.integers(0, 52, n).astype(np.int32))
    ca = T.chroma_residual_tiles_ref(qpc, qpr, cdc, cac, n, ls4, ls4)
    cb = T.chroma_residual_tiles(qpc, qpr, cdc, cac, n, ls4, ls4)
    assert np.array_equal(np.asarray(ca), np.asarray(cb))
