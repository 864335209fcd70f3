"""Intra wavefront reconstruction as ONE Pallas kernel (Triton route) for
NVIDIA GPUs.

The XLA formulation (kernels/wavefront.make_wavefront_fn) walks the
n_diag anti-diagonals of a frame as a ``lax.scan`` whose step nests the
16 sequential 4x4 blocks and the 4 sequential 8x8 blocks of an intra MB
as inner loops: on a GPU that is thousands of small dependent launches
per batch.  This kernel runs one program per frame that walks every
diagonal, block and row in-kernel:

- lanes are the macroblocks of one diagonal (K <= 60 at 1080p), padded to
  a power of two Kp; every tensor is (rows, Kp);
- the frontier is the kernel's own output: the tiles of diagonals d-1,
  d-2 and d-3 are re-read at lane offsets (diag_shifts) from the output
  buffers, which stay L2-resident;
- a 17 x 25 per-frame window scratch holds the MB's aprons (row -1 incl.
  the above-right MB, col -1) and the samples the sequential 4x4 / 8x8
  blocks write and re-read; each block's neighbor samples, prediction
  taps and residual rows are gathered through static tables;
- ``debug_barrier`` (a block-wide barrier) separates every store from the
  re-load of the same locations by other threads.

Output tiles are bit-identical to the XLA scan (tests/
test_pallas_wavefront.py) and use its diagonal layout, so the deblocking
wavefront and the plane assembly consume them unchanged.
"""
from __future__ import annotations

from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt

from ..avc.neighbors import ZSCAN_4X4_POS
from ..coeffs import KIND_I4, KIND_I8, KIND_I16, KIND_PCM
from .pred_tables import filter_tables_8x8, tables_4x4, tables_8x8
from .wavefront import (BLK4_A, BLK4_B, BLK4_C, BLK8_A, BLK8_B, BLK8_C,
                        BLK8_D, diag_schedule, diag_shifts, merge_pcm_and_slim,
                        tiles_to_planes)

WROWS = 512          # window scratch rows (17 * 25 = 425 used)
META_ROWS = 32       # kind i16 chroma avail_a..d | modes4 x16 | modes8 x4
ROW_M4, ROW_M8 = 7, 23


def _wrow(py: int, px: int) -> int:
    """Window row of MB-relative pixel (px, py); -1 addresses the aprons."""
    return (py + 1) * 25 + (px + 1)


@lru_cache(maxsize=None)
def _tables():
    """Every static gather table, flattened into one int32 vector.

    Returns (flat, offsets)."""
    parts = {}
    # ---- 4x4 blocks: window rows of the 13 samples [corner, above 0..7,
    # left 0..3]; ac = above-right available (else above 4..7 replicate
    # above 3)
    nb4 = np.zeros((16, 2, 13), np.int32)
    for blk, (bx, by) in enumerate(ZSCAN_4X4_POS):
        x0, y0 = 4 * bx, 4 * by
        for ac in (0, 1):
            nb4[blk, ac, 0] = _wrow(y0 - 1, x0 - 1)
            for i in range(8):
                nb4[blk, ac, 1 + i] = _wrow(y0 - 1, x0 + (i if i < 4 or ac
                                                          else 3))
            for j in range(4):
                nb4[blk, ac, 9 + j] = _wrow(y0 + j, x0 - 1)
    I4, W4, R4, S4 = tables_4x4()
    parts["t4i"] = np.pad(nb4[:, :, I4], [(0, 0)] * 4 + [(0, 1)])
    parts["t4w"] = np.pad(W4, ((0, 0), (0, 0), (0, 1)))
    parts["r4"], parts["s4"] = R4, S4
    parts["bc4"] = np.stack([BLK4_A, BLK4_B, BLK4_C, BLK4_C], 1)
    parts["dc4"] = np.concatenate([nb4[:, 1, 1:5], nb4[:, 1, 9:13]], 1)
    st4 = np.zeros((16, 16), np.int32)
    rs4 = np.zeros((16, 16), np.int32)
    for blk, (bx, by) in enumerate(ZSCAN_4X4_POS):
        for dy in range(4):
            for dx in range(4):
                st4[blk, 4 * dy + dx] = _wrow(4 * by + dy, 4 * bx + dx)
                rs4[blk, 4 * dy + dx] = 16 * (4 * by + dy) + 4 * bx + dx
    parts["st4"], parts["rs4"] = st4, rs4
    # ---- 8x8 blocks: 25 raw samples [corner, above 0..15, left 0..7]
    raw8 = np.zeros((4, 2, 32), np.int32)
    st8 = np.zeros((4, 64), np.int32)
    rs8 = np.zeros((4, 64), np.int32)
    for blk in range(4):
        x0, y0 = 8 * (blk & 1), 8 * (blk >> 1)
        for ac in (0, 1):
            raw8[blk, ac, 0] = _wrow(y0 - 1, x0 - 1)
            for i in range(16):
                raw8[blk, ac, 1 + i] = _wrow(y0 - 1, x0 + (i if i < 8 or ac
                                                           else 7))
            for j in range(8):
                raw8[blk, ac, 17 + j] = _wrow(y0 + j, x0 - 1)
        for dy in range(8):
            for dx in range(8):
                st8[blk, 8 * dy + dx] = _wrow(y0 + dy, x0 + dx)
                rs8[blk, 8 * dy + dx] = 16 * (y0 + dy) + x0 + dx
    parts["raw8"], parts["st8"], parts["rs8"] = raw8, st8, rs8
    (F1i, F1w, _, _), (F0i, F0w, _, _) = filter_tables_8x8()
    fi = np.zeros((2, 32, 4), np.int32)        # [ad, r, t] sample index
    fw = np.zeros((2, 32, 4), np.int32)
    fi[1, :25, :3], fw[1, :25, :3] = F1i, F1w
    fi[0, :25, :3], fw[0, :25, :3] = F0i, F0w
    parts["t8f"] = raw8[:, :, fi]             # [blk, ac, ad, r, t]
    parts["fw8"] = fw
    I8, W8, R8, S8 = tables_8x8()
    parts["t8i"] = np.pad(I8, ((0, 0), (0, 0), (0, 1)))
    parts["t8w"] = np.pad(W8, ((0, 0), (0, 0), (0, 1)))
    parts["r8"], parts["s8"] = R8, S8
    parts["bc8"] = np.stack([BLK8_A, BLK8_B, BLK8_C, BLK8_D], 1)
    offs, flat, t = {}, [], 0
    for k, v in parts.items():
        offs[k] = t
        flat.append(np.asarray(v, np.int32).reshape(-1))
        t += flat[-1].size
    return np.concatenate(flat), offs


def lane_pad(K: int) -> int:
    """Lanes per diagonal: a power of two >= 16 holding K macroblocks."""
    return max(16, 1 << (K - 1).bit_length())


def _build_kernel(n_diag: int, Kp: int, interpret: bool):
    _, O = _tables()
    maxv = 255
    dcv = 128

    def barrier():
        if not interpret:          # the interpreter runs programs serially
            plt.debug_barrier()

    def iota(n):
        return jax.lax.broadcasted_iota(jnp.int32, (n, 1), 0)

    def bc(idx):
        return jnp.broadcast_to(idx, (idx.shape[0], Kp))

    def rowsum(x, r):
        """Row r of a register tensor x (R, Kp) -> (1, Kp)."""
        return jnp.sum(jnp.where(iota(x.shape[0]) == r, x, 0), axis=0,
                       keepdims=True)

    def kernel(shifts_ref, tab_ref, meta_ref, yres_ref, cres_ref,
               ty_ref, tc_ref, w_ref, fs_ref):
        f = pl.program_id(0)
        lane = jax.lax.broadcasted_iota(jnp.int32, (1, Kp), 1)

        def tab(off, idx):
            return plt.load(tab_ref.at[off + idx])

        def tab2(off, idx):
            """(R, Kp) table gather."""
            return plt.load(tab_ref.at[bc(off + idx)])

        def wload(rows):
            return plt.load(w_ref.at[f, bc(rows), bc(lane)])

        def wstore(rows, val, mask):
            plt.store(w_ref.at[f, bc(rows), bc(lane)], val,
                      mask=jnp.broadcast_to(mask, val.shape))

        def diag(d, carry):
            s_ab = shifts_ref[d, 0]
            s_ar = shifts_ref[d, 1]
            s_lf = shifts_ref[d, 2]
            s_cn = shifts_ref[d, 3]

            def meta(r):
                return meta_ref[f, d, pl.ds(r, 1), :]

            kind = meta(0)
            i16m = meta(1)
            cmode = meta(2)
            av = [None, meta(3) != 0, meta(4) != 0, meta(5) != 0,
                  meta(6) != 0]

            def avail(code):
                """Availability source code (wavefront.BLK*_*) -> (1, Kp)."""
                out = code == 0
                for c in (1, 2, 3, 4):
                    out = out | ((code == c) & av[c])
                return out

            def prev(ref, dd, s, rows):
                """Pixel rows of diagonal d-dd's tiles at lane offset s."""
                dp = d - dd
                ln = lane + s
                ok = (dp >= 0) & (ln >= 0) & (ln < Kp)
                v = plt.load(ref.at[f, jnp.maximum(dp, 0), bc(rows),
                                    bc(jnp.clip(ln, 0, Kp - 1))],
                             mask=jnp.broadcast_to(ok, (rows.shape[0], Kp)),
                             other=0)
                return v.astype(jnp.int32)

            def resid(rows):
                return plt.load(yres_ref.at[f, d, bc(rows), bc(lane)]
                                ).astype(jnp.int32)

            def dc_of(suma, suml, aa, ab, shift):
                return jnp.where(aa & ab, (suma + suml + (1 << shift)) >>
                                 (shift + 1),
                                 jnp.where(aa, (suml + (1 << (shift - 1)))
                                           >> shift,
                                           jnp.where(ab, (suma + (1 << (
                                               shift - 1))) >> shift, dcv)))

            # ---- aprons: previous diagonals' tiles -> window row/col -1
            r16 = iota(16)
            r8 = iota(8)
            one = jnp.zeros((1, 1), jnp.int32)
            wstore(1 + r16, prev(ty_ref, 2, s_ab, 240 + r16), True)
            wstore(17 + r8, prev(ty_ref, 1, s_ar, 240 + r8), True)
            wstore(one, prev(ty_ref, 3, s_cn, one + 255), True)
            wstore(25 * (1 + r16), prev(ty_ref, 1, s_lf, 16 * r16 + 15),
                   True)
            barrier()

            # ---- I4: 16 dependent 4x4 blocks in z-scan order -------------
            is4 = kind == KIND_I4

            def i4(blk, c):
                aa = avail(tab_ref[O["bc4"] + 4 * blk])
                ab = avail(tab_ref[O["bc4"] + 4 * blk + 1])
                ac = avail(tab_ref[O["bc4"] + 4 * blk + 2]).astype(jnp.int32)
                m = meta_ref[f, d, pl.ds(ROW_M4 + blk, 1), :]
                base = ((blk * 2 + ac) * 9 + m) * 64 + 4 * r16
                acc = tab2(O["r4"], m * 16 + r16)
                for t in range(3):
                    acc += (tab2(O["t4w"], m * 64 + 4 * r16 + t)
                            * wload(tab2(O["t4i"], base + t)))
                pred = acc >> tab2(O["s4"], m * 16 + r16)
                dv = wload(tab(O["dc4"], blk * 8 + r8))
                suma = jnp.sum(jnp.where(r8 < 4, dv, 0), 0, keepdims=True)
                suml = jnp.sum(jnp.where(r8 >= 4, dv, 0), 0, keepdims=True)
                pred = jnp.where(m == 2, dc_of(suma, suml, aa, ab, 2), pred)
                u = jnp.clip(pred + resid(tab(O["rs4"], blk * 16 + r16)), 0,
                             maxv)
                wstore(tab(O["st4"], blk * 16 + r16), u, is4)
                barrier()
                return c

            jax.lax.fori_loop(0, 16, i4, 0)

            # ---- I8: 4 dependent 8x8 blocks on filtered samples ---------
            is8 = kind == KIND_I8
            r32 = iota(32)

            def i8(blk, c):
                aa = avail(tab_ref[O["bc8"] + 4 * blk])
                ab = avail(tab_ref[O["bc8"] + 4 * blk + 1])
                ac = avail(tab_ref[O["bc8"] + 4 * blk + 2]).astype(jnp.int32)
                ad = avail(tab_ref[O["bc8"] + 4 * blk + 3])
                adi = ad.astype(jnp.int32)
                raw = wload(tab2(O["raw8"], (blk * 2 + ac) * 32 + r32))
                facc = jnp.full((32, Kp), 2, jnp.int32)
                for t in range(3):
                    row = tab2(O["t8f"],
                               ((blk * 2 + ac) * 2 + adi) * 128 + 4 * r32 + t)
                    facc += (tab2(O["fw8"], adi * 128 + 4 * r32 + t)
                             * wload(row))
                filt = facc >> 2
                z = rowsum(raw, 0)
                a0 = rowsum(raw, 1)
                l0 = rowsum(raw, 17)
                fz = jnp.where(aa & ab, (a0 + 2 * z + l0 + 2) >> 2,
                               jnp.where(ab, (3 * z + a0 + 2) >> 2,
                                         jnp.where(aa, (3 * z + l0 + 2) >> 2,
                                                   z)))
                fz = jnp.where(ad, fz, z)
                in_a = (r32 >= 1) & (r32 <= 16)
                in_l = (r32 >= 17) & (r32 <= 24)
                use = (in_a & ab) | (in_l & aa)
                samp = jnp.where(r32 == 0, fz, jnp.where(use, filt, raw))
                plt.store(fs_ref.at[f, bc(r32), bc(lane)], samp)
                barrier()
                suma = jnp.sum(jnp.where((r32 >= 1) & (r32 <= 8), samp, 0),
                               0, keepdims=True)
                suml = jnp.sum(jnp.where(in_l, samp, 0), 0, keepdims=True)
                dc = dc_of(suma, suml, aa, ab, 3)
                m = meta_ref[f, d, pl.ds(ROW_M8 + blk, 1), :]

                def chunk(q, c2):
                    p = 16 * q + r16
                    acc = tab2(O["r8"], m * 64 + p)
                    for t in range(3):
                        srow = tab2(O["t8i"], m * 256 + 4 * p + t)
                        acc += (tab2(O["t8w"], m * 256 + 4 * p + t)
                                * plt.load(fs_ref.at[f, srow, bc(lane)]))
                    pred = acc >> tab2(O["s8"], m * 64 + p)
                    pred = jnp.where(m == 2, dc, pred)
                    u = jnp.clip(pred + resid(tab(O["rs8"], blk * 64 + p)),
                                 0, maxv)
                    wstore(tab(O["st8"], blk * 64 + p), u, is8)
                    return c2

                jax.lax.fori_loop(0, 4, chunk, 0)
                barrier()
                return c

            jax.lax.fori_loop(0, 4, i8, 0)

            # ---- I16 / PCM and the final select, one pixel row at a time
            # window row 0 is the corner: the x = 7 / y = 7 plane terms
            above = wload(1 + r16)
            left = wload(25 * (1 + r16))
            hi = wload(9 + r8)
            lo = wload(jnp.where(r8 < 7, 7 - r8, 0))
            hh = jnp.sum((r8 + 1) * (hi - lo), 0, keepdims=True)
            hi = wload(25 * (9 + r8))
            lo = wload(jnp.where(r8 < 7, 25 * (7 - r8), 0))
            vv = jnp.sum((r8 + 1) * (hi - lo), 0, keepdims=True)
            b = (5 * hh + 32) >> 6
            cc = (5 * vv + 32) >> 6
            a16 = 16 * (rowsum(above, 15) + rowsum(left, 15))
            dc16 = dc_of(jnp.sum(above, 0, keepdims=True),
                         jnp.sum(left, 0, keepdims=True), av[1], av[2], 4)
            is16 = kind == KIND_I16
            ispcm = kind == KIND_PCM

            def luma_row(y, c):
                pl_ = jnp.clip((a16 + b * (r16 - 7) + cc * (y - 7) + 16) >> 5,
                               0, maxv)
                p16 = jnp.where(i16m == 0, above,
                                jnp.where(i16m == 1, rowsum(left, y),
                                          jnp.where(i16m == 2, dc16, pl_)))
                rs = resid(16 * y + r16)
                o = jnp.where(ispcm, rs,
                              jnp.where(is16, jnp.clip(p16 + rs, 0, maxv),
                                        wload(25 * (1 + y) + 1 + r16)))
                plt.store(ty_ref.at[f, d, bc(16 * y + r16), bc(lane)],
                          o.astype(jnp.uint8))
                return c

            jax.lax.fori_loop(0, 16, luma_row, 0)

            # ---- chroma (4:2:0): both planes, from previous diagonals -----
            for ci in range(2):
                cab = prev(tc_ref, 2, s_ab, 64 * ci + 56 + r8)
                ccn = prev(tc_ref, 3, s_cn, one + 64 * ci + 63)
                clf = prev(tc_ref, 1, s_lf, 64 * ci + 8 * r8 + 7)
                asum = [jnp.sum(jnp.where((r8 >= q) & (r8 < q + 4), cab, 0),
                                0, keepdims=True) for q in (0, 4)]
                lsum = [jnp.sum(jnp.where((r8 >= q) & (r8 < q + 4), clf, 0),
                                0, keepdims=True) for q in (0, 4)]
                a_, b_ = av[1], av[2]
                q00 = dc_of(asum[0], lsum[0], a_, b_, 2)
                q11 = dc_of(asum[1], lsum[1], a_, b_, 2)
                q01 = jnp.where(b_, (asum[1] + 2) >> 2,
                                jnp.where(a_, (lsum[0] + 2) >> 2, dcv))
                q10 = jnp.where(a_, (lsum[1] + 2) >> 2,
                                jnp.where(b_, (asum[0] + 2) >> 2, dcv))
                hs = 0
                vs = 0
                for x in range(4):
                    hs = hs + (x + 1) * (rowsum(cab, 4 + x) -
                                         (rowsum(cab, 2 - x) if x <= 2
                                          else ccn))
                    vs = vs + (x + 1) * (rowsum(clf, 4 + x) -
                                         (rowsum(clf, 2 - x) if x <= 2
                                          else ccn))
                cb_ = (34 * hs + 32) >> 6
                cc_ = (34 * vs + 32) >> 6
                ca = 16 * (rowsum(cab, 7) + rowsum(clf, 7))

                def chroma_row(y, c, ci=ci, cab=cab, clf=clf, q00=q00,
                               q01=q01, q10=q10, q11=q11, cb_=cb_, cc_=cc_,
                               ca=ca):
                    top = y < 4
                    dcr = jnp.where(r8 < 4, jnp.where(top, q00, q10),
                                    jnp.where(top, q01, q11))
                    pp = jnp.clip((ca + cb_ * (r8 - 3) + cc_ * (y - 3) + 16)
                                  >> 5, 0, maxv)
                    pc = jnp.where(cmode == 0, dcr,
                                   jnp.where(cmode == 1, rowsum(clf, y),
                                             jnp.where(cmode == 2, cab, pp)))
                    rows = 64 * ci + 8 * y + r8
                    rs = plt.load(cres_ref.at[f, d, bc(rows), bc(lane)]
                                  ).astype(jnp.int32)
                    o = jnp.where(ispcm, rs, jnp.clip(pc + rs, 0, maxv))
                    plt.store(tc_ref.at[f, d, bc(rows), bc(lane)],
                              o.astype(jnp.uint8))
                    return c

                jax.lax.fori_loop(0, 8, chroma_row, 0)
            barrier()
            return carry

        jax.lax.fori_loop(0, n_diag, diag, 0)

    return kernel


@lru_cache(maxsize=None)
def make_wavefront_kernel(mb_w: int, mb_h: int, F: int,
                          interpret: bool = False):
    """The kernel over F frames.  Returns fn(shifts, tab, meta, yres,
    cres) -> (ty [F,n_diag,256,Kp] u8, tc [F,n_diag,128,Kp] u8) in the
    kernel's lane-minor layout (see make_gop_wavefront_kernel_fn)."""
    sched, _, _ = diag_schedule(mb_w, mb_h)
    n_diag, K = sched.shape
    Kp = lane_pad(K)
    kernel = _build_kernel(n_diag, Kp, interpret)
    out_shape = [
        jax.ShapeDtypeStruct((F, n_diag, 256, Kp), jnp.uint8),
        jax.ShapeDtypeStruct((F, n_diag, 128, Kp), jnp.uint8),
        jax.ShapeDtypeStruct((F, WROWS, Kp), jnp.int32),      # window
        jax.ShapeDtypeStruct((F, 32, Kp), jnp.int32),         # 8x8 samples
    ]
    call = pl.pallas_call(
        kernel, out_shape=out_shape, grid=(F,),
        compiler_params=plt.CompilerParams(num_warps=4, num_stages=1),
        interpret=interpret, backend="triton", name="intra_wavefront")

    def run(*args):
        return call(*args)[:2]

    return run


def make_gop_wavefront_kernel_fn(mb_w: int, mb_h: int, deblock: bool = False,
                                 interpret: bool = False):
    """Drop-in for kernels.wavefront.make_gop_wavefront_fn running the
    Pallas kernel: fn(syntax [F,n,...], y_resid [F,n,16,16], c_resid
    [F,n,2,8,8], pre=None) -> (y, cb, cr) uint8 [F, H, W] planes."""
    sched_np, d_of, k_of = diag_schedule(mb_w, mb_h)
    n_diag, K = sched_np.shape
    Kp = lane_pad(K)
    shifts = np.stack(diag_shifts(mb_w, mb_h), axis=1).astype(np.int32)
    addrs = np.maximum(sched_np, 0)
    valid = np.pad(sched_np >= 0, ((0, 0), (0, Kp - K)))
    flat, _ = _tables()
    d_of = jnp.asarray(d_of)
    k_of = jnp.asarray(k_of)
    if deblock:
        from .deblock import make_deblock_tiles_fn
        dbfn = make_deblock_tiles_fn(mb_w, mb_h)

    def lanes(a):
        """[F, n, *rest] -> [F, n_diag, prod(rest), Kp] (lane-minor)."""
        F = a.shape[0]
        g = a[:, addrs].reshape(F, n_diag, K, -1)
        g = jnp.pad(g, ((0, 0), (0, 0), (0, Kp - K), (0, 0)))
        return jnp.transpose(g, (0, 1, 3, 2))

    def run(s, y_resid, c_resid, pre=None):
        F = y_resid.shape[0]
        s = dict(s)
        s["y_resid"] = y_resid
        s["c_resid"] = c_resid
        s = jax.vmap(merge_pcm_and_slim)(s)
        ok = jnp.asarray(valid)[None, :, None, :]
        cols = [s["kind"][..., None], s["i16_mode"][..., None],
                s["chroma_mode"][..., None]]
        cols += [s[k][..., None] for k in ("avail_a", "avail_b", "avail_c",
                                           "avail_d")]
        cols += [s["modes4"], s["modes8"]]
        meta = jnp.concatenate([c.astype(jnp.int32) for c in cols], -1)
        meta = jnp.pad(meta, ((0, 0), (0, 0), (0, META_ROWS - 27)))
        meta = lanes(meta)
        # padding lanes: PCM with zero samples, nothing available
        rows = jnp.arange(META_ROWS)[None, None, :, None]
        meta = jnp.where(ok, meta, jnp.where(rows == 0, KIND_PCM, 0))
        meta = jnp.where((rows >= 3) & (rows <= 6), meta & ok, meta)
        yres = jnp.where(ok, lanes(s["y_resid"]), 0)
        cres = jnp.where(ok, lanes(s["c_resid"]), 0)
        ty, tc = make_wavefront_kernel(mb_w, mb_h, F, interpret)(
            jnp.asarray(shifts), jnp.asarray(flat), meta,
            yres.astype(jnp.int16), cres.astype(jnp.int16))
        ty = jnp.transpose(ty[..., :K], (0, 1, 3, 2)) \
            .reshape(F, n_diag, K, 16, 16)
        tc = jnp.transpose(tc[..., :K], (0, 1, 3, 2)) \
            .reshape(F, n_diag, K, 2, 8, 8)
        if deblock:
            ty, tc = jax.vmap(dbfn)(ty, tc, pre)
        return jax.vmap(lambda a, b: tiles_to_planes(
            a, b, d_of, k_of, mb_w, mb_h))(ty, tc)

    return run
