"""Packed-wire device I/P/B decode: the 1080p-capable device inter path.

Per picture:
  1. C++ slice-parallel entropy decode (native/entropy.cc, full I/P/B
     CABAC syntax).
  2. C++ motion derivation in motion_only mode (native/recon.cc): MV
     prediction / skip / direct modes are neighbor-chained integer
     recurrences — host work, like CABAC — exporting a dense per-4x4
     motion field.
  3. ONE compact host->device blob: the bitmap coefficient ABI of the
     intra GOP pipeline (gop_pipeline.py) extended with the motion
     field (int16 MVs, int8 reference-stack slots / list indices) and
     the per-picture weighted-prediction tables.  ~2 MB/frame at 1080p
     where the per-array legacy path (device_ipb.py) ships ~15 MB
     through 30+ transfers.
  4. Device (jit): densify -> residual tiles; MC over the
     device-resident reference stack (kernels/inter.py mc_frame) with
     weighted prediction resolved on device; the intra wavefront
     reconstructs intra MBs with inter tiles riding the PCM channel;
     in-loop deblocking with edge parameters precomputed on device
     (kernels/deblock.py deblock_precompute_jax — including the inter
     boundary-strength rules over the shipped motion field).

Reconstructed planes stay in device HBM as reference pictures; output
is drained in one batched D2H.  The upstream reference has no inter
reconstruction at all (/root/reference/src/video/frame/mod.rs:88
`todo!("Inter prediction")`) and no notion of a decoded-picture plane
store (/root/reference/src/video/slice/dpb.rs:802 tracks POC metadata
only).
"""
from __future__ import annotations

import ctypes as ct

import numpy as np

from .coeffs import KIND_I4, KIND_I8, KIND_PCM

U8_STRIDE = 19
I16_STRIDE = 408

_IPB_SPEC = (("bmp", np.uint8, "npad,51"),
             ("vals", np.int8, "npad,W"),
             ("exc_idx", np.int32, "ecap"),
             ("exc_delta", np.int16, "ecap"),
             ("ovf_idx", np.int32, "ovcap"),
             ("ovf_rows", np.int16, "ovcap,408"),
             ("u8", np.uint8, "n,19"),
             ("mv", np.int16, "n4,2,2"),
             ("rsri", np.int8, "n4,4"),
             ("wp_expl", np.int16, "2,32,6"),
             ("wp_imp", np.int16, "256,2"),
             ("misc", np.int32, "4"))


def _shapes(npad, n, n4, W, ecap, ovcap):
    env = dict(npad=npad, n=n, n4=n4, W=W, ecap=ecap, ovcap=ovcap)
    out = {}
    for name, dt, spec in _IPB_SPEC:
        shape = tuple(env.get(tok) or int(tok) for tok in spec.split(","))
        out[name] = (shape, dt)
    return out


def _layout(npad, n, n4, W, ecap, ovcap):
    offs = {}
    t = 0
    for name, (shape, dt) in _shapes(npad, n, n4, W, ecap, ovcap).items():
        t = (t + 63) & ~63
        offs[name] = (t, shape, dt)
        t += int(np.prod(shape)) * np.dtype(dt).itemsize
    return offs, t


def _alloc(npad, n, n4, W, ecap, ovcap):
    offs, total = _layout(npad, n, n4, W, ecap, ovcap)
    blob = np.zeros(total, np.uint8)
    views = {name: np.ndarray(shape, dt, buffer=blob, offset=off)
             for name, (off, shape, dt) in offs.items()}
    views["ovf_idx"][:] = npad
    return blob, views


_SPLIT_CACHE: dict = {}


def _splitter(npad, n, n4, W, ecap, ovcap):
    """Per-section single-slice jitted programs (slice + bitcast)."""
    key = (npad, n, n4, W, ecap, ovcap)
    fn = _SPLIT_CACHE.get(key)
    if fn is not None:
        return fn
    import jax
    import jax.numpy as jnp
    offs, _ = _layout(npad, n, n4, W, ecap, ovcap)
    jdt = {np.dtype(np.uint8): jnp.uint8, np.dtype(np.int8): jnp.int8,
           np.dtype(np.int16): jnp.int16, np.dtype(np.int32): jnp.int32}

    def seg_fn(name):
        off, shape, dt = offs[name]
        dt = np.dtype(dt)
        nb = int(np.prod(shape)) * dt.itemsize
        jd = jdt[dt]

        def one(blob):
            x = blob[off:off + nb]
            if dt.itemsize == 1:
                y = (x if jd == jnp.uint8
                     else jax.lax.bitcast_convert_type(x, jd))
            else:
                y = jax.lax.bitcast_convert_type(
                    x.reshape(-1, dt.itemsize), jd)
            return y.reshape(shape)

        return jax.jit(one)

    fns = {name: seg_fn(name) for name, _d, _s in _IPB_SPEC}

    def split(blob):
        return {name: f(blob) for name, f in fns.items()}

    fn = _SPLIT_CACHE[key] = split
    return fn


_FN_CACHE: dict = {}


def _make_pic_fn(mb_w, mb_h, deblocked, wp_mode, c0, c1, W, ecap, ovcap,
                 nlists=2, interpret=False):
    """jit((blob segments..., refs_y [R,H,W] u8, refs_cb, refs_cr))
    -> (y [H,W], cb, cr) uint8 reconstructed (+deblocked) planes.

    nlists: 0 = all-intra picture (no MC at all), 1 = P (list 0 only),
    2 = B: static per-picture-type variants, so an unused list's windows
    are never gathered."""
    key = (mb_w, mb_h, deblocked, wp_mode, c0, c1, W, ecap, ovcap, nlists,
           interpret)
    fn = _FN_CACHE.get(key)
    if fn is not None:
        return fn
    import jax
    import jax.numpy as jnp

    from .avc.neighbors import ZSCAN_4X4_POS
    from .kernels.deblock import deblock_precompute_jax, PRE_KEYS
    from .kernels.densify import unpack_coeffs
    from .kernels.inter import mc_frame, resolve_wp_blocks_jax
    from .kernels.transform import (LS4_FLAT, LS8_FLAT,
                                    chroma_residual_tiles,
                                    luma_residual_tiles)
    from .kernels.wavefront_kernel import make_gop_wavefront_kernel_fn
    from .refimpl.transform import QPC_TAB

    n = mb_w * mb_h
    n4 = n * 16
    qpc_tab = jnp.asarray(QPC_TAB, jnp.int32)
    recon = make_gop_wavefront_kernel_fn(mb_w, mb_h, deblocked, interpret)
    ls4 = jnp.asarray(LS4_FLAT)
    ls8 = jnp.asarray(LS8_FLAT)

    def qpc_vec(qp, off):
        qpi = jnp.clip(qp + off, 0, 51)
        return jnp.where(qpi < 30, qpi, qpc_tab[jnp.clip(qpi - 30, 0, 21)])

    # prep (densify/residuals/MC/precompute) and the wavefront recon run
    # as two jitted programs chained through device arrays

    def run(g, refs_y, refs_cb, refs_cr):
        dense = unpack_coeffs(g["bmp"], g["vals"], g["exc_idx"],
                              g["exc_delta"], g["ovf_idx"], g["ovf_rows"])
        lanes = dense[:n].astype(jnp.int32)

        u8 = g["u8"]
        kind_raw = u8[:, 0].astype(jnp.int32)
        t8 = (kind_raw >> 6) & 1
        kind = kind_raw & 0x3F
        inter = (kind >= 4) & (kind <= 10)
        qp_y = u8[:, 1].astype(jnp.int32)
        rkind = jnp.where(inter,
                          jnp.where(t8 == 1, KIND_I8, KIND_I4), kind)

        y_resid = luma_residual_tiles(
            rkind, qp_y, lanes[:, :256].reshape(n, 16, 4, 4),
            lanes[:, :256].reshape(n, 4, 8, 8),
            lanes[:, 256:272].reshape(n, 4, 4), n, ls4, ls8)
        qp_cb = qpc_vec(qp_y, c0)
        qp_cr = qpc_vec(qp_y, c1)
        c_resid = chroma_residual_tiles(
            qp_cb, qp_cr, lanes[:, 272:280].reshape(n, 2, 2, 2),
            lanes[:, 280:408].reshape(n, 2, 4, 4, 4), n, ls4, ls4)

        mv = g["mv"].astype(jnp.int32)                    # [n4,2,2]
        rsri = g["rsri"].astype(jnp.int32)                # [n4,4]
        rs0, rs1, ri0, ri1 = (rsri[:, 0], rsri[:, 1], rsri[:, 2],
                              rsri[:, 3])
        if nlists == 0:
            tile_y = y_resid       # no inter MBs: tiles never selected
            tile_c = c_resid
        else:
            misc = g["misc"]
            wp = resolve_wp_blocks_jax(ri0, ri1, wp_mode, g["wp_expl"],
                                       misc[0], misc[1], g["wp_imp"],
                                       misc[2])
            pred_y, pred_c = mc_frame(
                refs_y, refs_cb, refs_cr, rs0,
                rs1 if nlists == 2 else None, mv[:, 0],
                mv[:, 1] if nlists == 2 else None, wp, mb_w, mb_h)
            tile_y = jnp.clip(pred_y + y_resid, 0, 255)
            tile_c = jnp.clip(pred_c + c_resid, 0, 255)

        # syntax dict for the wavefront: inter tiles ride the PCM channel
        sid = (u8[:, 14].astype(jnp.int32)
               | (u8[:, 15].astype(jnp.int32) << 8))
        sid2 = sid.reshape(mb_h, mb_w)
        neg = jnp.full((mb_h, mb_w), -9, jnp.int32)
        nb_a = neg.at[:, 1:].set(sid2[:, :-1])
        nb_b = neg.at[1:, :].set(sid2[:-1, :])
        nb_c = neg.at[1:, :-1].set(sid2[:-1, 1:])
        nb_d = neg.at[1:, 1:].set(sid2[:-1, :-1])
        m4n = u8[:, 4:12]
        modes4 = jnp.stack([m4n & 0xF, m4n >> 4], axis=-1).reshape(n, 16)
        m8n = u8[:, 12:14]
        modes8 = jnp.stack([m8n & 0xF, m8n >> 4], axis=-1).reshape(n, 4)
        s = {
            "kind": jnp.where(inter, KIND_PCM, kind).astype(jnp.uint8),
            "i16_mode": u8[:, 2],
            "chroma_mode": u8[:, 3],
            "modes4": modes4,
            "modes8": modes8,
            "avail_a": (nb_a == sid2).reshape(n),
            "avail_b": (nb_b == sid2).reshape(n),
            "avail_c": (nb_c == sid2).reshape(n),
            "avail_d": (nb_d == sid2).reshape(n),
            "pcm_y": jnp.where(inter[:, None, None], tile_y, 0),
            "pcm_c": jnp.where(inter[:, None, None, None], tile_c, 0),
        }
        s1 = {k: v[None] for k, v in s.items()}
        if not deblocked:
            return s1, y_resid[None], c_resid[None]

        # device inter deblock precompute: nz per 4x4 block from the
        # densified lanes (packed rows are exact zeros for uncoded and
        # skip blocks), motion/slot grids from the shipped field
        dis = u8[:, 16].astype(jnp.int32)
        offa = u8[:, 17].astype(jnp.int32) - 12
        offb = u8[:, 18].astype(jnp.int32) - 12
        nzz = lanes[:, :256].reshape(n, 16, 16).any(-1)      # z blocks
        nz8 = lanes[:, :256].reshape(n, 4, 64).any(-1)
        blk = jnp.arange(16)
        nz_z = jnp.where((t8 == 1)[:, None] | (kind == KIND_I8)[:, None],
                         nz8[:, blk >> 2], nzz)
        H4, W4 = mb_h * 4, mb_w * 4
        # z-scan -> raster block grid as one static gather + transpose
        perm = np.zeros(16, np.int32)
        for z in range(16):
            ox, oy = ZSCAN_4X4_POS[z]
            perm[oy * 4 + ox] = z
        nz4 = (nz_z[:, jnp.asarray(perm)]
               .reshape(mb_h, mb_w, 4, 4).transpose(0, 2, 1, 3)
               .reshape(H4, W4))
        pre = deblock_precompute_jax(
            kind, qp_y, sid, dis, offa, offb, mb_w, mb_h, c0, c1,
            t8, nz4, mv[:, 0].reshape(H4, W4, 2),
            mv[:, 1].reshape(H4, W4, 2), rs0.reshape(H4, W4),
            rs1.reshape(H4, W4))
        pre1 = {k: pre[k][None] for k in PRE_KEYS}
        return s1, y_resid[None], c_resid[None], pre1

    prep_j = jax.jit(run)
    recon_j = jax.jit(lambda *a: recon(*a))

    def fn(g, refs_y, refs_cb, refs_cr):
        parts = prep_j(g, refs_y, refs_cb, refs_cr)
        y, cb, cr = recon_j(*parts)
        return y[0], cb[0], cr[0]

    _FN_CACHE[key] = fn
    return fn


def decode_annexb_device_packed(stream: bytes, max_frames: int = 0,
                                n_threads: int = 0, device_out: bool = False,
                                interpret: bool = False):
    """Decode an Annex-B I/P/B stream with packed-wire device recon.

    Same output contract as device_ipb.decode_annexb_device; falls back
    to the native host path for features outside the device scope
    (mirrors decode_annexb_device's fallback set) and for PCM streams."""
    from .avc import split_annexb
    from .avc.dpb import DecodedPictureBuffer
    from .avc.slice_header import SliceHeader, SliceType
    from .decoder import DecodedFrame, SyntaxDecoder, group_access_units
    from .kernels.densify import BLK, round_up
    from .native.entropy import (_ptr, decode_picture_slices, lib,
                                 pack_frame)
    from .native.full import _build_inter_params, wp_tables, _u8p
    import jax
    import jax.numpy as jnp

    sd = SyntaxDecoder()
    nals = list(split_annexb(stream))
    rest = sd.feed_parameter_sets(nals)
    dpb = DecodedPictureBuffer()
    stored: dict[int, object] = {}
    dev: dict[int, tuple] = {}
    frames = []
    order = []
    epoch = -1

    class _Meta:
        pass

    W, ecap, ovcap = 32, 1024, 256
    bufs = None      # allocated at first picture (geometry known)
    npad = n = n4 = 0
    cur = 0

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
            if (sps.chroma_array_type != 1
                    or h.field_pic_flag
                    or (not sps.frame_mbs_only_flag
                        and sps.mb_adaptive_frame_field_flag)
                    or sps.bit_depth_luma_minus8
                    or sps.qpprime_y_zero_transform_bypass_flag
                    or pps.slice_groups is not None
                    or pps.constrained_intra_pred_flag
                    or not pps.entropy_coding_mode_flag
                    or st in (SliceType.SP, SliceType.SI)
                    or pps.pic_scaling_matrix_present_flag
                    or sps.seq_scaling_matrix_present_flag):
                from .native.full import decode_annexb_native
                return decode_annexb_native(stream, max_frames,
                                            n_threads=n_threads)
            headers.append(h)
            bitoff = (h.header_bit_len + 7) & ~7
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
                                    n_threads=n_threads, reuse=True)
        mb_w, mb_h = sps.pic_width_in_mbs, sps.frame_height_in_mbs
        if bufs is None:
            n = mb_w * mb_h
            n4 = n * 16
            npad = round_up(n, BLK)
            bufs = [_alloc(npad, n, n4, W, ecap, ovcap) for _ in range(2)]
        if bool((out["kind"][:n] == 3).any()):   # PCM -> native restart
            from .native.full import decode_annexb_native
            return decode_annexb_native(stream, max_frames,
                                        n_threads=n_threads)
        is_inter_pic = bool((out["kind"][:n] >= 4).any()
                            and not (out["kind"][:n] == 11).all())
        deblocked = any(h.deblocking is None or h.deblocking.disable_idc != 1
                        for h in headers)
        off1 = pps.second_chroma_qp_index_offset
        if off1 is None:
            off1 = pps.chroma_qp_index_offset

        exp = {k: np.zeros(n4 * 2, np.int32) for k in ("mv0", "mv1")}
        for k in ("ri0", "ri1", "rk0", "rk1"):
            exp[k] = np.full(n4, -1, np.int32)
        nz4 = np.zeros(n4, np.uint8)
        wp_mode = 0
        expl = dy = dc = imp = None
        used_keys = []
        if is_inter_pic:
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
            l0 = dpb.ref_list0
            l1 = (dpb.ref_list1 if h0.slice_type == SliceType.B else [])
            used_keys = sorted({p.frame_idx for p in l0} |
                               {p.frame_idx for p in l1})
            wp_mode, expl, dy, dc, imp = wp_tables(h0, pps, poc, l0, l1)

        # ---- fill the wire blob --------------------------------------
        blob, v = bufs[cur]
        ctl = np.asarray([(1, 0, 0) if h.deblocking is not None
                          and h.deblocking.disable_idc == 1 else
                          (0, 0, 0) if h.deblocking is None else
                          (h.deblocking.disable_idc,
                           h.deblocking.alpha_c0_offset_div2 * 2,
                           h.deblocking.beta_offset_div2 * 2)
                          for h in headers], np.int32)
        while True:
            v["exc_idx"][:] = 0
            v["exc_delta"][:] = 0
            v["ovf_idx"][:] = npad
            maxnz, nexc, novf = pack_frame(
                out, n, W, ctl, v["bmp"], v["vals"],
                np.zeros(npad, np.int32), v["u8"], v["exc_idx"],
                v["exc_delta"], v["ovf_idx"], v["ovf_rows"],
                n_threads=n_threads, inter=True)
            assert maxnz >= 0   # PCM handled above
            if (nexc <= ecap and novf <= ovcap
                    and not (maxnz > W and W < 256
                             and novf * 816 > npad * 32)):
                break
            if maxnz > W and W < 256 and novf * 816 > npad * 32:
                W = min(max(32, (maxnz + 31) & ~31), 256)
            if nexc > ecap:
                ecap = max(1024, (nexc + 1023) & ~1023)
            if novf > ovcap:
                ovcap = max(256, (novf + 255) & ~255)
            bufs = [_alloc(npad, n, n4, W, ecap, ovcap) for _ in range(2)]
            blob, v = bufs[cur]
        if is_inter_pic:
            v["mv"][:, 0] = exp["mv0"].reshape(n4, 2)
            v["mv"][:, 1] = exp["mv1"].reshape(n4, 2)
            slot = np.full((max(used_keys) + 2) if used_keys else 2, -1,
                           np.int64)
            for i, k in enumerate(used_keys):
                slot[k] = i
            v["rsri"][:, 0] = np.where(exp["rk0"] >= 0,
                                       slot[np.clip(exp["rk0"], 0, None)],
                                       -1)
            v["rsri"][:, 1] = np.where(exp["rk1"] >= 0,
                                       slot[np.clip(exp["rk1"], 0, None)],
                                       -1)
            v["rsri"][:, 2] = np.clip(exp["ri0"], -1, 31)
            v["rsri"][:, 3] = np.clip(exp["ri1"], -1, 31)
            v["wp_expl"][:] = 0
            if wp_mode == 1 and expl is not None:
                v["wp_expl"][:, :expl.shape[1]] = expl
            v["wp_imp"][:] = 0
            n_ref1 = 1
            if wp_mode == 2 and imp is not None:
                flat = imp.reshape(-1, 2)[:256]
                v["wp_imp"][:flat.shape[0]] = flat
                n_ref1 = imp.shape[1]
            v["misc"][:] = (dy or 0, dc or 0, n_ref1, 0)
        else:
            v["mv"][:] = 0
            v["rsri"][:] = -1
            v["wp_expl"][:] = 0
            v["wp_imp"][:] = 0
            v["misc"][:] = 0
            wp_mode = 0

        # reference stacks (device-resident)
        H, Wpix = mb_h * 16, mb_w * 16
        if used_keys:
            refs_y = jnp.stack([dev[k][0] for k in used_keys])
            refs_cb = jnp.stack([dev[k][1] for k in used_keys])
            refs_cr = jnp.stack([dev[k][2] for k in used_keys])
        else:
            refs_y = jnp.zeros((1, H, Wpix), jnp.uint8)
            refs_cb = jnp.zeros((1, H // 2, Wpix // 2), jnp.uint8)
            refs_cr = jnp.zeros((1, H // 2, Wpix // 2), jnp.uint8)

        g = _splitter(npad, n, n4, W, ecap, ovcap)(jnp.asarray(blob))
        nlists = (0 if not is_inter_pic else
                  2 if any(h.slice_type == SliceType.B for h in headers)
                  else 1)
        fn = _make_pic_fn(mb_w, mb_h, deblocked, wp_mode,
                          pps.chroma_qp_index_offset, off1, W, ecap,
                          ovcap, nlists=nlists, interpret=interpret)
        y, cb, cr = fn(g, refs_y, refs_cb, refs_cr)

        pic = dpb.mark_and_store(sps, h0, nal0, poc)
        if pic is not None:
            dev[pic.frame_idx] = (y, cb, cr)
            m = _Meta()
            m.y = m.cb = m.cr = np.zeros(1, np.uint8)
            m.mv0, m.mv1 = exp["mv0"].copy(), exp["mv1"].copy()
            m.ri0, m.ri1 = exp["ri0"].copy(), exp["ri1"].copy()
            m.rk0, m.rk1 = exp["rk0"].copy(), exp["rk1"].copy()
            m.list0_keys = [p.frame_idx for p in dpb.ref_list0]
            stored[pic.frame_idx] = m
            live = {p.frame_idx for p in dpb.pictures}
            stored = {k: x for k, x in stored.items() if k in live}
            dev = {k: x for k, x in dev.items() if k in live}

        frames.append((y, cb, cr, poc, sps))
        order.append((epoch, poc))
        cur ^= 1
        if max_frames and len(frames) >= max_frames + 16:
            break
    frames = [f for _, f in sorted(zip(order, frames), key=lambda t: t[0])]
    if max_frames:
        frames = frames[:max_frames]
    if device_out:
        return frames
    ys = np.asarray(jnp.stack([f[0] for f in frames]))
    cbs = np.asarray(jnp.stack([f[1] for f in frames]))
    crs = np.asarray(jnp.stack([f[2] for f in frames]))
    return [DecodedFrame(ys[i], cbs[i], crs[i], f[3]).crop(f[4])
            for i, f in enumerate(frames)]
