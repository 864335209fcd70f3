"""The wavefront kernel (kernels/wavefront_kernel.py) is bit-exact vs its
plain reference, the XLA scan (kernels/wavefront.make_wavefront_fn).

The CPU suite runs the kernel in Pallas interpret mode; the ``gpu`` test
compiles it for the card (python chip_smoke.py covers the same path at
1080p)."""
import numpy as np
import pytest

from dryv_tpu.coeffs import KIND_I4, KIND_I8, KIND_I16, KIND_PCM


def _random_syntax(rng, mb_w, mb_h, F, pcm=True):
    n = mb_w * mb_h
    kinds = [KIND_I4, KIND_I8, KIND_I16] + ([KIND_PCM] if pcm else [])
    s = {
        "kind": rng.choice(kinds, size=(F, n)).astype(np.int32),
        "i16_mode": rng.integers(0, 4, (F, n)).astype(np.int32),
        "chroma_mode": rng.integers(0, 4, (F, n)).astype(np.int32),
        "modes4": rng.integers(0, 9, (F, n, 16)).astype(np.int32),
        "modes8": rng.integers(0, 9, (F, n, 4)).astype(np.int32),
        "pcm_y": rng.integers(0, 256, (F, n, 16, 16)).astype(np.int32),
        "pcm_c": rng.integers(0, 256, (F, n, 2, 8, 8)).astype(np.int32),
    }
    # geometric availability (single slice, no constrained intra)
    x = np.arange(n) % mb_w
    y = np.arange(n) // mb_w
    av_a = (x > 0)
    av_b = (y > 0)
    av_c = (y > 0) & (x < mb_w - 1)
    av_d = (y > 0) & (x > 0)
    for k, v in (("avail_a", av_a), ("avail_b", av_b),
                 ("avail_c", av_c), ("avail_d", av_d)):
        s[k] = np.broadcast_to(v, (F, n)).copy()
    # mask modes that would read unavailable neighbors to keep the stream
    # "legal" (real bitstreams never select them)
    need_b = {0: True, 3: True, 7: True}
    need_a = {1: True, 8: True}
    for blk_modes, navail in ((s["modes4"], 16), (s["modes8"], 4)):
        m = blk_modes
        m[~s["avail_b"]] = np.where(
            np.isin(m[~s["avail_b"]], list(need_b)), 2, m[~s["avail_b"]])
        m[~s["avail_a"]] = np.where(
            np.isin(m[~s["avail_a"]], list(need_a)), 2, m[~s["avail_a"]])
        m[~(s["avail_a"] & s["avail_b"])] = np.where(
            np.isin(m[~(s["avail_a"] & s["avail_b"])], [4, 5, 6]), 2,
            m[~(s["avail_a"] & s["avail_b"])])
    s["i16_mode"] = np.where(s["avail_a"] & s["avail_b"], s["i16_mode"],
                             2).astype(np.int32)
    s["chroma_mode"] = np.where(s["avail_a"] & s["avail_b"],
                                s["chroma_mode"], 0).astype(np.int32)
    y_resid = rng.integers(-300, 300, (F, n, 16, 16)).astype(np.int32)
    c_resid = rng.integers(-300, 300, (F, n, 2, 8, 8)).astype(np.int32)
    return s, y_resid, c_resid


def _xla_reference(s, y_resid, c_resid, mb_w, mb_h):
    import jax
    from dryv_tpu.kernels.wavefront import make_gop_wavefront_fn

    return [np.asarray(p) for p in
            jax.jit(make_gop_wavefront_fn(mb_w, mb_h))(s, y_resid, c_resid)]


def _kernel(s, y_resid, c_resid, mb_w, mb_h, interpret):
    import jax
    from dryv_tpu.kernels.wavefront_kernel import (
        make_gop_wavefront_kernel_fn)

    fn = make_gop_wavefront_kernel_fn(mb_w, mb_h, interpret=interpret)
    return [np.asarray(p) for p in jax.jit(fn)(s, y_resid, c_resid)]


@pytest.mark.parametrize("geom,F", [((8, 6), 2), ((5, 3), 4), ((1, 1), 1)])
def test_pallas_matches_xla_random(geom, F):
    mb_w, mb_h = geom
    rng = np.random.default_rng(7 * mb_w + mb_h)
    s, y_resid, c_resid = _random_syntax(rng, mb_w, mb_h, F)
    want = _xla_reference(s, y_resid, c_resid, mb_w, mb_h)
    got = _kernel(s, y_resid, c_resid, mb_w, mb_h, interpret=True)
    for g, w in zip(got, want):
        assert np.array_equal(g, w)


def test_pallas_pipeline_fixture_bit_exact():
    """Stage A + the kernel (+ the deblocking wavefront) on real fixtures
    vs their libavcodec goldens."""
    import jax
    import jax.numpy as jnp
    from dryv_tpu.coeffs import pack_frame
    from dryv_tpu.decoder import SyntaxDecoder, group_access_units
    from dryv_tpu.avc import split_annexb
    from dryv_tpu.gop_pipeline import make_gop_pipeline, stack_gop_compact
    from dryv_tpu.kernels.deblock import PRE_KEYS, deblock_precompute_intra
    from dryv_tpu.kernels.transform import LS4_FLAT, LS8_FLAT
    from dryv_tpu.testing.fixtures import get_fixture

    ls = [jnp.asarray(LS4_FLAT)] * 3 + [jnp.asarray(LS8_FLAT)]
    for name, deblock in (("mix_qp26", False), ("dblk_mix_qp26", True)):
        stream, (gy, gcb, gcr), sps, pps = get_fixture(name)
        sd = SyntaxDecoder()
        rest = sd.feed_parameter_sets(list(split_annexb(stream)))
        _, _, mbs, headers = sd.decode_picture_syntax(
            group_access_units(rest)[0])
        fs = pack_frame(mbs, sps, pps)
        F = 2
        pre = None
        if deblock:
            ctl = [(0, 0, 0) if h.deblocking is None else
                   (h.deblocking.disable_idc,
                    h.deblocking.alpha_c0_offset_div2 * 2,
                    h.deblocking.beta_offset_div2 * 2) for h in headers]
            sid = np.zeros(fs.n_mbs, np.int32)
            for i, h in enumerate(headers):
                sid[h.first_mb_in_slice:] = i
            p1 = deblock_precompute_intra(
                fs.kind, fs.qp_y, sid, ctl, fs.mb_w, fs.mb_h,
                pps.chroma_qp_index_offset, pps.second_chroma_qp_offset)
            pre = {k: np.stack([p1[k]] * F) for k in PRE_KEYS}
        fn = jax.jit(make_gop_pipeline(fs.mb_w, fs.mb_h, deblock,
                                       interpret=True))
        y, cb, cr = fn(stack_gop_compact([fs] * F), *ls, pre)
        for f in range(F):
            assert np.array_equal(np.asarray(y[f])[:gy.shape[0],
                                                   :gy.shape[1]], gy), name
            assert np.array_equal(np.asarray(cb[f])[:gcb.shape[0],
                                                    :gcb.shape[1]], gcb)
            assert np.array_equal(np.asarray(cr[f])[:gcr.shape[0],
                                                    :gcr.shape[1]], gcr)


@pytest.fixture
def gpu():
    import jax
    try:
        return jax.devices("gpu")[0]
    except RuntimeError:
        pytest.skip("no GPU: the kernel compiles only for the card "
                    "(python chip_smoke.py runs it at 1080p)")


@pytest.mark.gpu
def test_kernel_compiled_for_gpu(gpu):
    """The kernel as compiled for the card, not interpreted."""
    import jax
    with jax.default_device(gpu):
        rng = np.random.default_rng(11)
        s, y_resid, c_resid = _random_syntax(rng, 12, 7, 3)
        want = _xla_reference(s, y_resid, c_resid, 12, 7)
        got = _kernel(s, y_resid, c_resid, 12, 7, interpret=False)
    for g, w in zip(got, want):
        assert np.array_equal(g, w)
