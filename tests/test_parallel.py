"""Multi-device sharding on the virtual 8-device CPU mesh: frame-parallel
GOP decode, band-parallel wavefront with halo exchange, 2-D mesh."""
import numpy as np
import pytest

from dryv_tpu.avc import split_annexb
from dryv_tpu.coeffs import pack_frame
from dryv_tpu.decoder import SyntaxDecoder, group_access_units
from dryv_tpu.parallel import make_mesh
from dryv_tpu.parallel.bands import make_banded_frame_fn
from dryv_tpu.parallel.gop import decode_gop_sharded
from dryv_tpu.testing.fixtures import get_fixture


@pytest.fixture(scope="module")
def frame_syntax():
    stream, golden, _, _ = get_fixture("mix_qp26")
    sd = SyntaxDecoder()
    rest = sd.feed_parameter_sets(list(split_annexb(stream)))
    sps, pps, mbs, _ = sd.decode_picture_syntax(group_access_units(rest)[0])
    return pack_frame(mbs, sps, pps), golden


@pytest.mark.parametrize("pad", [True, False])
def test_gop_sharded(frame_syntax, pad):
    """Every shard runs the wavefront kernel (interpret mode here) over
    its frames; pad=True leaves a GOP the mesh must pad to 8 frames."""
    fs, (gy, gcb, gcr) = frame_syntax
    mesh = make_mesh({"gop": 8})
    F = 7 if pad else 8
    ys, cbs, crs = decode_gop_sharded([fs] * F, mesh, interpret=True)
    assert len(ys) == F
    for i in range(F):
        assert np.array_equal(ys[i], gy)
        assert np.array_equal(cbs[i], gcb)
        assert np.array_equal(crs[i], gcr)


@pytest.mark.parametrize("n_bands", [2, 3])
def test_band_sharded_halo_exchange(frame_syntax, n_bands):
    fs, (gy, gcb, gcr) = frame_syntax
    mesh = make_mesh({"band": n_bands})
    fn = make_banded_frame_fn(mesh, fs.mb_w, fs.mb_h)
    y, cb, cr = fn(fs)
    assert np.array_equal(y, gy)
    assert np.array_equal(cb, gcb)
    assert np.array_equal(cr, gcr)


def test_2d_mesh(frame_syntax):
    fs, (gy, gcb, gcr) = frame_syntax
    mesh = make_mesh({"gop": 2, "band": 2})
    fn = make_banded_frame_fn(mesh, fs.mb_w, fs.mb_h)
    y, cb, cr = fn(fs)
    assert np.array_equal(y, gy)
    assert np.array_equal(cb, gcb)
    assert np.array_equal(cr, gcr)


def test_graft_entry():
    import __graft_entry__ as ge
    fn, args = ge.entry(interpret=True)
    y, cb, cr = fn(*args)
    assert y.shape == (64, 64)


@pytest.mark.parametrize("n_bands", [2, 4])
def test_banded_p_frame_halo(n_bands):
    """Banded P-frame reconstruction (the last SURVEY 2.10 partial):
    motion compensation over band-sharded reference planes with a
    ppermute apron of reference rows, bit-exact vs the single-device
    mc_frame path — MVs deliberately reach across band boundaries."""
    import jax.numpy as jnp
    from dryv_tpu.kernels.inter import mc_frame
    from dryv_tpu.parallel.bands import make_banded_p_recon_fn

    mb_w, mb_h = 6, 8
    H, W = mb_h * 16, mb_w * 16
    n = mb_w * mb_h
    n4 = n * 16
    rng = np.random.RandomState(3)
    ref_y = rng.randint(0, 256, (H, W)).astype(np.uint8)
    ref_cb = rng.randint(0, 256, (H // 2, W // 2)).astype(np.uint8)
    ref_cr = rng.randint(0, 256, (H // 2, W // 2)).astype(np.uint8)
    # quarter-pel MVs reaching up to +-12 integer rows (crosses the
    # 2-MB-row bands) and beyond the frame edges horizontally
    mv = np.stack([rng.randint(-220, 221, n4),
                   rng.randint(-48, 49, n4)], axis=1).astype(np.int32)
    rs = np.zeros(n4, np.int32)
    y_resid = rng.randint(-30, 31, (n, 16, 16)).astype(np.int32)
    c_resid = rng.randint(-30, 31, (n, 2, 8, 8)).astype(np.int32)

    # single-device reference result
    wp = {k: np.zeros(n4, np.int32) for k in
          ["oy0", "oy1", "dy", "ocb0", "ocb1", "ocr0", "ocr1", "dc"]}
    for k in ["wy0", "wy1", "wcb0", "wcb1", "wcr0", "wcr1"]:
        wp[k] = np.ones(n4, np.int32)
    wpj = {k: jnp.asarray(v) for k, v in wp.items()}
    py, pc = mc_frame(jnp.asarray(ref_y)[None], jnp.asarray(ref_cb)[None],
                      jnp.asarray(ref_cr)[None], jnp.asarray(rs),
                      None, jnp.asarray(mv), None, wpj, mb_w, mb_h)
    gy = np.clip(np.asarray(py) + y_resid, 0, 255).astype(np.uint8)
    gc = np.clip(np.asarray(pc) + c_resid, 0, 255).astype(np.uint8)
    gyp = (gy.reshape(mb_h, mb_w, 16, 16).transpose(0, 2, 1, 3)
           .reshape(H, W))
    gcb = (gc[:, 0].reshape(mb_h, mb_w, 8, 8).transpose(0, 2, 1, 3)
           .reshape(H // 2, W // 2))
    gcr = (gc[:, 1].reshape(mb_h, mb_w, 8, 8).transpose(0, 2, 1, 3)
           .reshape(H // 2, W // 2))

    mesh = make_mesh({"band": n_bands})
    run = make_banded_p_recon_fn(mesh, mb_w, mb_h, apron=64)
    y, cb, cr = run(ref_y, ref_cb, ref_cr, mv, rs, y_resid, c_resid)
    assert np.array_equal(y, gyp), \
        f"luma: {np.sum(y != gyp)} px differ"
    assert np.array_equal(cb, gcb)
    assert np.array_equal(cr, gcr)
