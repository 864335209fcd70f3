"""Full I/P/B decode with device reconstruction.

Per picture:
  1. C++ slice-parallel entropy decode (native/entropy.cc).
  2. C++ motion derivation in motion_only mode (native/recon.cc): MV
     prediction / skip / direct modes are neighbor-chained integer
     recurrences — host work, like CABAC — exporting a dense per-4x4
     motion field (mv, reference picture keys) and nothing else.
  3. Device: batched IQ/IDCT residual tiles + the MC kernel
     (kernels/inter.py) over reference planes resident in device HBM
     (the device DPB) -> inter tiles = clip(pred + resid); the intra
     wavefront scan runs with inter tiles riding the PCM-passthrough
     channel (inter MBs have no intra-frame neighbor dependency, but
     their pixels feed neighboring intra MBs through the frontier).
  4. Device deblocking wavefront with full inter bS rules
     (kernels/deblock.py), parameters precomputed host-side.

Reconstructed planes stay on device as the reference pictures for
subsequent frames; only display output is copied to host.  The upstream
reference decoder has no inter reconstruction at all (frame/mod.rs:88
`todo!("Inter prediction")`).
"""
from __future__ import annotations

from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np

from .coeffs import KIND_I4, KIND_I8, KIND_PCM, pack_from_native
from .kernels.transform import (LS4_FLAT, LS8_FLAT, chroma_residual_tiles,
                                luma_residual_tiles)
from .kernels.inter import mc_frame, resolve_wp_blocks
from .kernels.deblock import deblock_precompute
from .kernels.wavefront_kernel import make_gop_wavefront_kernel_fn
from .pipeline import SYNTAX_KEYS

# native inter kind codes (entropy.py): 4..10 inter, 11 SI
_NK_SKIP = (6, 9)  # P_SKIP, B_SKIP

WP_KEYS = ["wy0", "oy0", "wy1", "oy1", "dy", "wcb0", "ocb0", "wcb1", "ocb1",
           "wcr0", "ocr0", "wcr1", "ocr1", "dc"]
MC_KEYS = ["rs0", "rs1", "mv0", "mv1", "inter", "skip", "rkind"] + WP_KEYS


@lru_cache(maxsize=None)
def _build_ipb(mb_w: int, mb_h: int, deblock: bool,
               interpret: bool = False):
    wavefront = make_gop_wavefront_kernel_fn(mb_w, mb_h, deblock, interpret)

    def recon(s, mc, refs_y, refs_cb, refs_cr, pre):
        n = mb_w * mb_h
        y_resid = luma_residual_tiles(
            mc["rkind"], s["qp_y"], s["luma4"], s["luma8"], s["luma_dc"],
            n, jnp.asarray(LS4_FLAT), jnp.asarray(LS8_FLAT))
        c_resid = chroma_residual_tiles(
            s["qp_cb"], s["qp_cr"], s["chroma_dc"], s["chroma_ac"], n,
            jnp.asarray(LS4_FLAT), jnp.asarray(LS4_FLAT))
        # skip MBs carry no residual (their coefficient slots are stale
        # under buffer reuse)
        skip = mc["skip"]
        y_resid = jnp.where(skip[:, None, None], 0, y_resid)
        c_resid = jnp.where(skip[:, None, None, None], 0, c_resid)

        pred_y, pred_c = mc_frame(refs_y, refs_cb, refs_cr,
                                  mc["rs0"], mc["rs1"], mc["mv0"],
                                  mc["mv1"], {k: mc[k] for k in WP_KEYS},
                                  mb_w, mb_h)
        tile_y = jnp.clip(pred_y + y_resid, 0, 255)
        tile_c = jnp.clip(pred_c + c_resid, 0, 255)

        inter = mc["inter"]
        wf = {k: s[k] for k in SYNTAX_KEYS if k not in
              ("qp_y", "qp_cb", "qp_cr", "luma4", "luma8", "luma_dc",
               "chroma_dc", "chroma_ac")}
        # inter tiles ride the PCM passthrough channel of the wavefront
        wf["kind"] = jnp.where(inter, KIND_PCM, s["kind"])
        wf["pcm_y"] = jnp.where(inter[:, None, None], tile_y, s["pcm_y"])
        wf["pcm_c"] = jnp.where(inter[:, None, None, None], tile_c,
                                s["pcm_c"])
        one = jax.tree.map(lambda a: a[None], (wf, y_resid, c_resid, pre))
        y, cb, cr = wavefront(*one)
        return y[0], cb[0], cr[0]

    return jax.jit(recon)


def _ctl(headers):
    return [(0, 0, 0) if h.deblocking is None else
            (h.deblocking.disable_idc, h.deblocking.alpha_c0_offset_div2 * 2,
             h.deblocking.beta_offset_div2 * 2) for h in headers]


def _nz4_from_coeffs(out, mb_w, mb_h):
    """nz per raster 4x4 block from the dense coefficient arrays (8.7.2.1;
    8x8-transform MBs test the covering 8x8 block)."""
    from .avc.neighbors import ZSCAN_4X4_POS

    n = mb_w * mb_h
    kind = out["kind"]
    cbp = out["cbp"]
    skip = np.isin(kind, _NK_SKIP)
    nzz4 = out["luma4"].reshape(n, 16, 16).any(-1)          # z-blk
    nz8 = out["luma8"].reshape(n, 4, 64).any(-1)
    t8 = (out["transform8"] != 0) | (kind == KIND_I8)
    blk = np.arange(16)
    coded = ((cbp[:, None] >> (blk[None, :] >> 2)) & 1) != 0
    nz_z = np.where(t8[:, None], nz8[:, blk >> 2], nzz4) & coded
    nz_z &= ~skip[:, None]
    # z-scan -> raster block grid
    H4, W4 = mb_h * 4, mb_w * 4
    nz = np.zeros((H4, W4), bool)
    mxs = (np.arange(n) % mb_w) * 4
    mys = (np.arange(n) // mb_w) * 4
    for z in range(16):
        ox, oy = ZSCAN_4X4_POS[z]
        nz[mys + oy, mxs + ox] = nz_z[:, z]
    return nz


def decode_annexb_device(stream: bytes, max_frames: int = 0,
                         n_threads: int = 0, device_out: bool = False,
                         interpret: bool = False):
    """Decode an Annex-B I/P/B stream with device reconstruction + MC
    (interpret=True runs the wavefront kernel in Pallas interpret mode).

    Falls back to the native host path for
    features outside the device scope (mirrors native/full.py's own
    fallback set, plus constrained intra prediction).

    Dispatch is fully asynchronous: the host loop never waits on the
    device (frame k+1's entropy/motion overlap frame k's device recon;
    the frame-to-frame reference dependency chains on device).  Host
    planes are drained in one batched D2H at the end; device_out=True
    skips the drain and returns (y, cb, cr, poc, sps) device tuples."""
    from .avc import split_annexb
    from .avc.dpb import DecodedPictureBuffer
    from .avc.slice_header import SliceHeader, SliceType
    from .decoder import DecodedFrame, SyntaxDecoder, group_access_units
    from .native.entropy import decode_picture_slices, lib, _ptr
    from .native.full import _build_inter_params, wp_tables, _u8p
    import ctypes as ct

    sd = SyntaxDecoder()
    nals = list(split_annexb(stream))
    rest = sd.feed_parameter_sets(nals)
    dpb = DecodedPictureBuffer()
    stored: dict[int, object] = {}   # motion metadata for col/direct
    dev: dict[int, tuple] = {}       # frame_idx -> device (y, cb, cr) uint8
    frames = []
    order = []
    epoch = -1   # display order = POC order within each IDR epoch

    class _Meta:
        pass

    for pic_nals in group_access_units(rest):
        headers = []
        slice_datas = []
        sps = pps = None
        for nal in pic_nals:
            rbsp = nal.rbsp
            probe_pps = next(iter(sd.pps_map.values()))
            probe_sps = next(iter(sd.sps_map.values()))
            h0p = SliceHeader.parse(rbsp, nal, probe_sps, probe_pps)
            pps = sd.pps_map[h0p.pic_parameter_set_id]
            sps = sd.sps_map[pps.seq_parameter_set_id]
            h = SliceHeader.parse(rbsp, nal, sps, pps)
            st = h.slice_type
            # RPLM stays in scope: ref-pic-list modification only
            # reorders the host-side list bookkeeping feeding the
            # device reference stack (dpb.build_ref_lists handles it)
            if (sps.chroma_array_type != 1
                    or h.field_pic_flag
                    or (not sps.frame_mbs_only_flag
                        and sps.mb_adaptive_frame_field_flag)
                    or sps.bit_depth_luma_minus8
                    or sps.qpprime_y_zero_transform_bypass_flag
                    or pps.slice_groups is not None
                    or pps.constrained_intra_pred_flag
                    or st in (SliceType.SP, SliceType.SI)
                    or pps.pic_scaling_matrix_present_flag
                    or sps.seq_scaling_matrix_present_flag):
                from .native.full import decode_annexb_native
                return decode_annexb_native(stream, max_frames,
                                            n_threads=n_threads)
            headers.append(h)
            bitoff = ((h.header_bit_len + 7) & ~7
                      if pps.entropy_coding_mode_flag else h.header_bit_len)
            slice_datas.append((rbsp, bitoff, h.first_mb_in_slice,
                                h.slice_qp_y(pps), int(st),
                                h.cabac_init_idc,
                                h.num_ref_idx_l0_active_minus1,
                                h.num_ref_idx_l1_active_minus1))
        h0 = headers[0]
        nal0 = pic_nals[0]
        if int(nal0.type) == 5:
            epoch += 1
        poc = dpb.decode_poc(sps, h0, nal0)
        dpb.build_ref_lists(sps, h0, poc)
        out = decode_picture_slices(slice_datas, sps, pps,
                                    n_threads=n_threads)
        mb_w, mb_h = sps.pic_width_in_mbs, sps.frame_height_in_mbs
        n = mb_w * mb_h
        n4 = n * 16
        is_inter_pic = bool((out["kind"] >= 4).any()
                            and not (out["kind"] == 11).all())

        deblocked = any(h.deblocking is None or h.deblocking.disable_idc != 1
                        for h in headers)
        fs = pack_from_native(out, sps, pps)
        off1 = pps.second_chroma_qp_index_offset
        if off1 is None:
            off1 = pps.chroma_qp_index_offset

        exp = {k: np.zeros(n4 * 2, np.int32) for k in ("mv0", "mv1")}
        for k in ("ri0", "ri1", "rk0", "rk1"):
            exp[k] = np.full(n4, -1, np.int32)
        nz4 = np.zeros(n4, np.uint8)

        if is_inter_pic:
            # host motion derivation (no pixel work)
            ip, keep = _build_inter_params(h0, pps, poc, dpb, stored, exp,
                                           nz4)
            ip.motion_only = 1
            dummy = np.zeros(1, np.uint8)
            lib().dt_recon_picture(
                _ptr(out["kind"]), _ptr(out["qp_y"]), _ptr(out["cbp"]),
                _ptr(out["i16_mode"]), _ptr(out["chroma_mode"]),
                _ptr(out["modes4"]), _ptr(out["modes8"]),
                _ptr(out["luma4"]), _ptr(out["luma8"]),
                _ptr(out["luma_dc"]), _ptr(out["chroma_dc"]),
                _ptr(out["chroma_ac"]), _ptr(out["pcm_y"]),
                _ptr(out["pcm_c"]), _ptr(out["slice_id"]),
                _ptr(out["mb_type_code"]), _ptr(out["sub_mb_type"]),
                _ptr(out["ref_idx"]), _ptr(out["mvd"]),
                _ptr(out["transform8"]),
                mb_w, mb_h, pps.chroma_qp_index_offset, off1,
                _u8p(dummy), _u8p(dummy), _u8p(dummy), ct.byref(ip))

            # reference stacks + per-block stack slots
            l0 = dpb.ref_list0
            l1 = dpb.ref_list1 if h0.slice_type == SliceType.B else []
            used_keys = sorted({p.frame_idx for p in l0} |
                               {p.frame_idx for p in l1})
            slot = np.full(max(used_keys) + 2, -1, np.int64)
            for i, k in enumerate(used_keys):
                slot[k] = i
            refs_y = jnp.stack([dev[k][0] for k in used_keys])
            refs_cb = jnp.stack([dev[k][1] for k in used_keys])
            refs_cr = jnp.stack([dev[k][2] for k in used_keys])
            rs0 = np.where(exp["rk0"] >= 0,
                           slot[np.clip(exp["rk0"], 0, None)], -1)
            rs1 = np.where(exp["rk1"] >= 0,
                           slot[np.clip(exp["rk1"], 0, None)], -1)
            wp_mode, expl, dy, dc, imp = wp_tables(h0, pps, poc, l0, l1)
            wp = resolve_wp_blocks(
                exp["ri0"], exp["ri1"], wp_mode,
                expl if expl is not None else np.zeros((2, 1, 6), np.int32),
                dy, dc,
                (imp.reshape(-1, 2) if imp is not None
                 else np.zeros((1, 2), np.int32)),
                imp.shape[1] if imp is not None else 1)
        else:
            rs0 = np.full(n4, -1, np.int32)
            rs1 = np.full(n4, -1, np.int32)
            wp = resolve_wp_blocks(rs0, rs1, 0, np.zeros((2, 1, 6),
                                   np.int32), 0, 0,
                                   np.zeros((1, 2), np.int32), 1)
            refs_y = jnp.zeros((1, mb_h * 16, mb_w * 16), jnp.uint8)
            refs_cb = jnp.zeros((1, mb_h * 8, mb_w * 8), jnp.uint8)
            refs_cr = jnp.zeros((1, mb_h * 8, mb_w * 8), jnp.uint8)

        kind = out["kind"]
        inter_mb = (kind >= 4) & (kind <= 10)
        t8 = (out["transform8"] != 0)
        rkind = np.where(inter_mb & t8, KIND_I8,
                         np.where(inter_mb, KIND_I4, kind)).astype(np.int32)
        skip_mb = np.isin(kind, _NK_SKIP)

        pre = None
        if deblocked:
            nz4g = _nz4_from_coeffs(out, mb_w, mb_h)
            pre = deblock_precompute(
                kind, out["qp_y"], out["slice_id"], _ctl(headers),
                mb_w, mb_h, pps.chroma_qp_index_offset, off1,
                t8=t8.astype(np.int32), nz4=nz4g,
                mv0=exp["mv0"].reshape(-1, 2), mv1=exp["mv1"].reshape(-1, 2),
                rk0=exp["rk0"], rk1=exp["rk1"])
            pre = {k: jnp.asarray(v) for k, v in pre.items()}

        mc = {
            "rs0": jnp.asarray(rs0.astype(np.int32)),
            "rs1": jnp.asarray(rs1.astype(np.int32)),
            "mv0": jnp.asarray(exp["mv0"].reshape(-1, 2)),
            "mv1": jnp.asarray(exp["mv1"].reshape(-1, 2)),
            "inter": jnp.asarray(inter_mb),
            "skip": jnp.asarray(skip_mb),
            "rkind": jnp.asarray(rkind),
        }
        for k in WP_KEYS:
            mc[k] = jnp.asarray(wp[k])
        s = {k: jnp.asarray(getattr(fs, k)) for k in SYNTAX_KEYS}
        fn = _build_ipb(mb_w, mb_h, deblocked, interpret)
        y, cb, cr = fn(s, mc, refs_y, refs_cb, refs_cr, pre)

        # store: device planes become reference pictures; host motion
        # metadata mirrors native/full.py's _Stored for direct modes
        pic = dpb.mark_and_store(sps, h0, nal0, poc)
        if pic is not None:
            yd = y.astype(jnp.uint8)
            cbd = cb.astype(jnp.uint8)
            crd = cr.astype(jnp.uint8)
            dev[pic.frame_idx] = (yd, cbd, crd)
            m = _Meta()
            m.y = m.cb = m.cr = np.zeros(1, np.uint8)  # host planes unused
            m.mv0, m.mv1 = exp["mv0"], exp["mv1"]
            m.ri0, m.ri1 = exp["ri0"], exp["ri1"]
            m.rk0, m.rk1 = exp["rk0"], exp["rk1"]
            m.list0_keys = [p.frame_idx for p in dpb.ref_list0]
            stored[pic.frame_idx] = m
            live = {p.frame_idx for p in dpb.pictures}
            stored = {k: v for k, v in stored.items() if k in live}
            dev = {k: v for k, v in dev.items() if k in live}

        frames.append((y, cb, cr, poc, sps))
        order.append((epoch, poc))
        if max_frames and len(frames) >= max_frames + 16:
            break
    frames = [f for _, f in sorted(zip(order, frames), key=lambda t: t[0])]
    if max_frames:
        frames = frames[:max_frames]
    if device_out:
        return frames
    # one batched D2H drain (a per-frame np.asarray would sync the
    # pipeline once per picture)
    ys = np.asarray(jnp.stack([f[0] for f in frames]))
    cbs = np.asarray(jnp.stack([f[1] for f in frames]))
    crs = np.asarray(jnp.stack([f[2] for f in frames]))
    return [DecodedFrame(ys[i], cbs[i], crs[i], f[3]).crop(f[4])
            for i, f in enumerate(frames)]
