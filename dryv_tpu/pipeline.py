"""End-to-end device reconstruction pipeline: FrameSyntax -> YUV planes.

Stage A (parallel IQ/IDCT) + Stage B (the wavefront kernel, + the
deblocking wavefront) jitted as one program.  Bit-exact against the
scalar refimpl / libavcodec goldens.  ``interpret=True`` runs the Pallas
kernel in interpret mode (CPU tests); nothing here chooses it.
"""
from __future__ import annotations

from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np

from .coeffs import FrameSyntax
from .kernels.transform import (
    LS4_FLAT,
    LS8_FLAT,
    chroma_residual_tiles,
    luma_residual_tiles,
)

SYNTAX_KEYS = ["kind", "qp_y", "qp_cb", "qp_cr", "i16_mode", "chroma_mode",
               "modes4", "modes8", "luma4", "luma8", "luma_dc", "chroma_dc",
               "chroma_ac", "pcm_y", "pcm_c",
               "avail_a", "avail_b", "avail_c", "avail_d"]


@lru_cache(maxsize=None)
def _build(mb_w: int, mb_h: int, deblock: bool = False,
           interpret: bool = False):
    from .kernels.wavefront_kernel import make_gop_wavefront_kernel_fn

    wavefront = make_gop_wavefront_kernel_fn(mb_w, mb_h, deblock, interpret)

    def recon(s, ls4y, ls4cb, ls4cr, ls8y, pre=None):
        n = mb_w * mb_h
        y_resid = luma_residual_tiles(
            s["kind"], s["qp_y"], s["luma4"], s["luma8"], s["luma_dc"],
            n, ls4y, ls8y)
        c_resid = chroma_residual_tiles(
            s["qp_cb"], s["qp_cr"], s["chroma_dc"], s["chroma_ac"], n,
            ls4cb, ls4cr)
        wf = {k: s[k] for k in SYNTAX_KEYS if k not in
              ("qp_y", "qp_cb", "qp_cr", "luma4", "luma8", "luma_dc",
               "chroma_dc", "chroma_ac")}
        one = jax.tree.map(lambda a: a[None], (wf, y_resid, c_resid, pre))
        y, cb, cr = wavefront(*one)
        return y[0], cb[0], cr[0]

    return jax.jit(recon)


def reconstruct_frame_jax(fs: FrameSyntax, ls4=None, ls8=None,
                          deblock_pre=None, interpret: bool = False):
    """Returns (y, cb, cr) numpy uint8-range int32 planes (uncropped).

    deblock_pre: edge-parameter dict from
    kernels.deblock.deblock_precompute_intra — runs the in-loop filter
    on device as a second wavefront pass."""
    s = {k: jnp.asarray(getattr(fs, k)) for k in SYNTAX_KEYS}
    ls4y = jnp.asarray(ls4[0] if ls4 is not None else LS4_FLAT)
    ls4cb = jnp.asarray(ls4[1] if ls4 is not None else LS4_FLAT)
    ls4cr = jnp.asarray(ls4[2] if ls4 is not None else LS4_FLAT)
    ls8y = jnp.asarray(ls8 if ls8 is not None else LS8_FLAT)
    if deblock_pre is not None:
        fn = _build(fs.mb_w, fs.mb_h, True, interpret)
        y, cb, cr = fn(s, ls4y, ls4cb, ls4cr, ls8y,
                       {k: jnp.asarray(v) for k, v in deblock_pre.items()})
    else:
        fn = _build(fs.mb_w, fs.mb_h, False, interpret)
        y, cb, cr = fn(s, ls4y, ls4cb, ls4cr, ls8y)
    return np.asarray(y), np.asarray(cb), np.asarray(cr)


def decode_annexb_fast(stream: bytes, max_frames: int = 0,
                       n_threads: int = 0, interpret: bool = False):
    """Production path: C++ entropy stage + JAX device reconstruction."""
    from .decoder import SyntaxDecoder, group_access_units, DecodedFrame
    from .avc import split_annexb
    from .avc.slice_header import SliceHeader
    from .coeffs import pack_from_native
    from .native.entropy import decode_picture_islices

    sd = SyntaxDecoder()
    nals = list(split_annexb(stream))
    rest = sd.feed_parameter_sets(nals)
    frames = []
    for pic_nals in group_access_units(rest):
        # parse headers only (cheap, Python); entropy decode in C++
        slice_datas = None
        headers = []
        sps = pps = None
        for nal in pic_nals:
            rbsp = nal.rbsp
            probe_pps = next(iter(sd.pps_map.values()))
            probe_sps = next(iter(sd.sps_map.values()))
            h0 = SliceHeader.parse(rbsp, nal, probe_sps, probe_pps)
            pps = sd.pps_map[h0.pic_parameter_set_id]
            sps = sd.sps_map[pps.seq_parameter_set_id]
            h = SliceHeader.parse(rbsp, nal, sps, pps)
            if not h.slice_type.is_intra or sps.chroma_array_type != 1 \
                    or h.field_pic_flag \
                    or sps.qpprime_y_zero_transform_bypass_flag \
                    or sps.bit_depth_luma_minus8 \
                    or pps.slice_groups is not None:
                # inter (P/B) and non-4:2:0/lossless streams run the
                # native C++ host path: reference-frame chains defeat
                # GOP batching, so at sub-HD sizes the host decoder beats
                # the per-frame wavefront dispatch cost.  The full device
                # inter pipeline (MC kernel + device deblock) is
                # decode_annexb_device (device_ipb.py; CLI
                # --backend device-ipb), bit-exact and preferable for
                # large frames / device-resident consumers.
                from .native.full import decode_annexb_native
                return decode_annexb_native(stream, max_frames,
                                            n_threads=n_threads)
            if slice_datas is None:
                slice_datas = []
            headers.append(h)
            bitoff = ((h.header_bit_len + 7) & ~7
                      if pps.entropy_coding_mode_flag else h.header_bit_len)
            slice_datas.append((rbsp, bitoff, h.first_mb_in_slice,
                                h.slice_qp_y(pps)))
        out = decode_picture_islices(slice_datas, sps, pps,
                                     n_threads=n_threads)
        fs = pack_from_native(out, sps, pps)
        ls4 = ls8 = None
        if sps.seq_scaling_matrix_present_flag \
                or pps.pic_scaling_matrix_present_flag:
            # custom weight matrices -> per-list LevelScale tables (intra
            # lists 0-2 + 8x8 intra; inter streams don't reach this path)
            from .refimpl.recon import dezigzag4, dezigzag8
            from .refimpl.transform import level_scale_4x4, level_scale_8x8
            sl = pps.resolve_active_scaling_lists(sps)
            ls4 = [np.asarray(level_scale_4x4(dezigzag4(sl.l4x4[i])),
                              np.int32) for i in range(3)]
            ls8 = np.asarray(level_scale_8x8(dezigzag8(sl.l8x8[0])),
                             np.int32)
        pre = None
        if any(h.deblocking is None or h.deblocking.disable_idc != 1
               for h in headers):
            # in-loop filter runs on device as a second wavefront pass
            from .kernels.deblock import deblock_precompute_intra
            ctl = [(0, 0, 0) if h.deblocking is None else
                   (h.deblocking.disable_idc,
                    h.deblocking.alpha_c0_offset_div2 * 2,
                    h.deblocking.beta_offset_div2 * 2) for h in headers]
            off1 = pps.second_chroma_qp_index_offset
            pre = deblock_precompute_intra(
                fs.kind, fs.qp_y, out["slice_id"], ctl, fs.mb_w, fs.mb_h,
                pps.chroma_qp_index_offset,
                off1 if off1 is not None else pps.chroma_qp_index_offset)
        y, cb, cr = reconstruct_frame_jax(fs, ls4, ls8, deblock_pre=pre,
                                          interpret=interpret)
        frames.append(DecodedFrame(y, cb, cr).crop(sps))
        if max_frames and len(frames) >= max_frames:
            break
    return frames


def _deblock_native_intra(y, cb, cr, out, sps, pps, headers):
    """Apply the C++ in-loop filter (native/deblock.cc) to an intra
    picture reconstructed on device, using the dense C++ entropy outputs
    (no MBState objects on this path)."""
    import ctypes as ct

    from .native.entropy import lib, _ptr
    from .refimpl.transform import QPC_TAB

    mb_w = sps.pic_width_in_mbs
    mb_h = sps.frame_height_in_mbs
    n = mb_w * mb_h
    kind = out["kind"]
    # native kind codes: recon path uses I16/I4/I8/PCM; PCM filters as QP 0
    from .native.entropy import NK_I8, NK_PCM
    qpy = np.where(kind == NK_PCM, 0, out["qp_y"]).astype(np.int32)

    def qpc(off):
        qpi = np.clip(qpy + off, 0, 51)
        return np.where(qpi < 30, qpi,
                        QPC_TAB[np.clip(qpi - 30, 0, 21)]).astype(np.int32)
    off0 = pps.chroma_qp_index_offset
    off1 = pps.second_chroma_qp_index_offset
    if off1 is None:
        off1 = off0
    ctl = []
    for h in headers:
        d = h.deblocking
        if d is None:
            ctl.append((0, 0, 0))
        else:
            ctl.append((d.disable_idc, d.alpha_c0_offset_div2 * 2,
                        d.beta_offset_div2 * 2))
    n4 = mb_h * 4 * mb_w * 4
    yy = np.ascontiguousarray(y, np.uint8)
    bb = np.ascontiguousarray(cb, np.uint8)
    rr = np.ascontiguousarray(cr, np.uint8)
    args = dict(
        qpc0=qpc(off0), qpc1=qpc(off1),
        intra=np.ones(n, np.uint8),
        t8=(kind == NK_I8).astype(np.uint8),
        sid=np.ascontiguousarray(out["slice_id"], np.int32),
        ctl=np.ascontiguousarray(np.array(ctl, np.int32).reshape(-1)),
        nz4=np.zeros(n4, np.uint8),
        mv=np.zeros(n4 * 2, np.int32), mv1=np.zeros(n4 * 2, np.int32),
        ref=np.full(n4, -1, np.int32), ref1=np.full(n4, -1, np.int32))
    U8 = ct.POINTER(ct.c_uint8)

    def u8p(a):
        return a.ctypes.data_as(U8)
    lib().dt_deblock_frame(
        u8p(yy), u8p(bb), u8p(rr), mb_w, mb_h, sps.chroma_array_type,
        _ptr(qpy), _ptr(args["qpc0"]), _ptr(args["qpc1"]),
        u8p(args["intra"]), u8p(args["t8"]), _ptr(args["sid"]),
        _ptr(args["ctl"]), u8p(args["nz4"]), _ptr(args["mv"]),
        _ptr(args["mv1"]), _ptr(args["ref"]), _ptr(args["ref1"]))
    return yy, bb, rr


def decode_annexb_tpu(stream: bytes, max_frames: int = 0,
                      interpret: bool = False):
    """Full decode using the device pipeline for reconstruction."""
    from .decoder import SyntaxDecoder, group_access_units, DecodedFrame
    from .avc import split_annexb
    from .coeffs import pack_frame
    from .refimpl.recon import dezigzag4, dezigzag8
    from .refimpl.transform import level_scale_4x4, level_scale_8x8

    sd = SyntaxDecoder()
    nals = list(split_annexb(stream))
    rest = sd.feed_parameter_sets(nals)
    frames = []
    for pic_nals in group_access_units(rest):
        sps, pps, mbs, headers = sd.decode_picture_syntax(pic_nals)
        if sps.chroma_array_type != 1 or headers[0].field_pic_flag \
                or sps.qpprime_y_zero_transform_bypass_flag or any(
                h.deblocking is None or h.deblocking.disable_idc != 1
                for h in headers):
            # device pipeline is 4:2:0 without the in-loop filter;
            # mono/4:2:2/deblocking streams use the scalar path
            from .decoder import decode_annexb_scalar
            return decode_annexb_scalar(stream, max_frames)
        fs = pack_frame(mbs, sps, pps)
        sl = pps.resolve_active_scaling_lists(sps)
        ls4 = [np.asarray(level_scale_4x4(dezigzag4(sl.l4x4[i])), np.int32)
               for i in range(3)]
        ls8 = np.asarray(level_scale_8x8(dezigzag8(sl.l8x8[0])), np.int32)
        y, cb, cr = reconstruct_frame_jax(fs, ls4, ls8, interpret=interpret)
        frames.append(DecodedFrame(y, cb, cr).crop(sps))
        if max_frames and len(frames) >= max_frames:
            break
    return frames
