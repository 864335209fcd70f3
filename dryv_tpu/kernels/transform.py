"""Stage A: inverse quantization + inverse transforms, batched over all
blocks of a frame (spec 8.5; reference transform.rs / pred16x16.rs /
trans_chroma.rs butterflies).

No cross-block dependencies (SURVEY.md §2.10) — everything here is
embarrassingly parallel VPU work with exact int32 arithmetic.  Produces
full-frame residual planes consumed by the wavefront stage.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..refimpl.transform import V4X4, V8X8, CLASS4, CLASS8
from ..coeffs import KIND_I16, KIND_I8

# Flat-16 level scale tables (fixtures/default); [6,4,4] / [6,8,8] int32.
LS4_FLAT = np.asarray(16 * V4X4[:, CLASS4], dtype=np.int32)
LS8_FLAT = np.asarray(16 * V8X8[:, CLASS8], dtype=np.int32)

# z-scan 4x4 block index -> (bx, by) in 4x4-block units
from ..avc.neighbors import ZSCAN_4X4_POS
ZPOS = np.array(ZSCAN_4X4_POS, dtype=np.int32)  # [16, 2] (x, y)


def dequant4(c, qp, ls4, dc_passthrough_mask=None):
    """c [N,4,4] int32, qp [N] int32, ls4 [6,4,4] -> d [N,4,4].

    dc_passthrough_mask: optional [N] bool — where True, d[0,0] = c[0,0]."""
    ls = ls4[qp % 6]  # [N,4,4]
    shift = qp // 6
    prod = c * ls
    hi = prod << jnp.maximum(shift - 4, 0)[:, None, None]
    rnd = 1 << jnp.clip(3 - shift, 0, 3)
    lo = (prod + rnd[:, None, None]) >> jnp.maximum(4 - shift, 0)[:, None, None]
    d = jnp.where((qp >= 24)[:, None, None], hi, lo)
    if dc_passthrough_mask is not None:
        d = d.at[:, 0, 0].set(jnp.where(dc_passthrough_mask, c[:, 0, 0],
                                        d[:, 0, 0]))
    return d


def idct4(d):
    """Butterfly 8.5.12.2: d [N,4,4] -> r [N,4,4] (with final rounding)."""
    d0, d1, d2, d3 = d[..., 0], d[..., 1], d[..., 2], d[..., 3]
    e0, e1 = d0 + d2, d0 - d2
    e2, e3 = (d1 >> 1) - d3, d1 + (d3 >> 1)
    f = jnp.stack([e0 + e3, e1 + e2, e1 - e2, e0 - e3], axis=-1)
    f0, f1, f2, f3 = f[..., 0, :], f[..., 1, :], f[..., 2, :], f[..., 3, :]
    g0, g1 = f0 + f2, f0 - f2
    g2, g3 = (f1 >> 1) - f3, f1 + (f3 >> 1)
    h = jnp.stack([g0 + g3, g1 + g2, g1 - g2, g0 - g3], axis=-2)
    return (h + 32) >> 6


def idct8(d):
    """8.5.13 two-stage butterfly: d [N,8,8] -> r [N,8,8]."""
    def stage(m):
        c = [m[..., k] for k in range(8)]
        e0 = c[0] + c[4]
        e1 = -c[3] + c[5] - c[7] - (c[7] >> 1)
        e2 = c[0] - c[4]
        e3 = c[1] + c[7] - c[3] - (c[3] >> 1)
        e4 = (c[2] >> 1) - c[6]
        e5 = -c[1] + c[7] + c[5] + (c[5] >> 1)
        e6 = c[2] + (c[6] >> 1)
        e7 = c[3] + c[5] + c[1] + (c[1] >> 1)
        f0 = e0 + e6
        f1 = e1 + (e7 >> 2)
        f2 = e2 + e4
        f3 = e3 + (e5 >> 2)
        f4 = e2 - e4
        f5 = (e3 >> 2) - e5
        f6 = e0 - e6
        f7 = e7 - (e1 >> 2)
        return jnp.stack([f0 + f7, f2 + f5, f4 + f3, f6 + f1,
                          f6 - f1, f4 - f3, f2 - f5, f0 - f7], axis=-1)
    g = stage(d)
    h = stage(jnp.swapaxes(g, -1, -2))
    return (jnp.swapaxes(h, -1, -2) + 32) >> 6


def dequant8(c, qp, ls8):
    ls = ls8[qp % 6]
    shift = qp // 6
    prod = c * ls
    hi = prod << jnp.maximum(shift - 6, 0)[:, None, None]
    rnd = 1 << jnp.clip(5 - shift, 0, 5)
    lo = (prod + rnd[:, None, None]) >> jnp.maximum(6 - shift, 0)[:, None, None]
    return jnp.where((qp >= 36)[:, None, None], hi, lo)


HAD4 = jnp.asarray([[1, 1, 1, 1], [1, 1, -1, -1],
                    [1, -1, -1, 1], [1, -1, 1, -1]], dtype=jnp.int32)
HAD2 = jnp.asarray([[1, 1], [1, -1]], dtype=jnp.int32)


def i16_dc(c, qp, ls4):
    """8.5.10: c [N,4,4] DC levels -> scaled DC values [N,4,4]."""
    f = jnp.einsum("ij,njk,kl->nil", HAD4, c, HAD4)
    ls00 = ls4[qp % 6, 0, 0][:, None, None]
    shift = (qp // 6)[:, None, None]
    hi = (f * ls00) << jnp.maximum(shift - 6, 0)
    rnd = 1 << jnp.clip(5 - shift, 0, 5)
    lo = (f * ls00 + rnd) >> jnp.maximum(6 - shift, 0)
    return jnp.where(shift >= 6, hi, lo)


def chroma_dc(c, qp, ls4):
    """8.5.11.1 (4:2:0): c [N,2,2] -> [N,2,2]."""
    f = jnp.einsum("ij,njk,kl->nil", HAD2, c, HAD2)
    ls00 = ls4[qp % 6, 0, 0][:, None, None]
    return ((f * ls00) << (qp // 6)[:, None, None]) >> 5


def luma_residual_tiles_ref(kind, qp_y, luma4, luma8, luma_dc, n, ls4, ls8):
    """Block-major reference implementation (round-1 layout; kept as the
    equality oracle for the lane-major fast path below)."""
    is16 = kind == KIND_I16
    # 4x4 path (I4 + I16-AC): dequant all, DC passthrough for I16
    qp_rep = jnp.repeat(qp_y, 16)
    c4 = luma4.reshape(n * 16, 4, 4)
    dcmask = jnp.repeat(is16, 16)
    # I16: insert scaled DC values into the blocks before IDCT
    dcv = i16_dc(luma_dc, qp_y, ls4)  # [n,4,4] indexed [y][x]
    zx, zy = ZPOS[:, 0], ZPOS[:, 1]
    dc_per_blk = dcv[:, zy, zx].reshape(n * 16)  # z-order per block
    c4 = c4.at[:, 0, 0].set(jnp.where(dcmask, dc_per_blk, c4[:, 0, 0]))
    d4 = dequant4(c4, qp_rep, ls4, dc_passthrough_mask=dcmask)
    r4 = idct4(d4).reshape(n, 16, 4, 4)
    # 8x8 path
    d8 = dequant8(luma8.reshape(n * 4, 8, 8), jnp.repeat(qp_y, 4), ls8)
    r8 = idct8(d8).reshape(n, 4, 8, 8)

    # assemble per-MB 16x16 residual
    r4_spatial = jnp.zeros((n, 16, 16), dtype=jnp.int32)
    for blk in range(16):
        bx, by = int(ZPOS[blk, 0]), int(ZPOS[blk, 1])
        r4_spatial = r4_spatial.at[:, by * 4:by * 4 + 4,
                                   bx * 4:bx * 4 + 4].set(r4[:, blk])
    r8_spatial = jnp.zeros((n, 16, 16), dtype=jnp.int32)
    for blk in range(4):
        bx, by = blk & 1, blk >> 1
        r8_spatial = r8_spatial.at[:, by * 8:by * 8 + 8,
                                   bx * 8:bx * 8 + 8].set(r8[:, blk])
    return jnp.where((kind == KIND_I8)[:, None, None], r8_spatial, r4_spatial)


def chroma_residual_tiles_ref(qp_cb, qp_cr, chroma_dc_lv, chroma_ac, n,
                              ls4cb, ls4cr):
    """Block-major reference implementation (see luma_residual_tiles_ref)."""
    outs = []
    for ci, (qp_c, ls4) in enumerate(((qp_cb, ls4cb), (qp_cr, ls4cr))):
        dcv = chroma_dc(chroma_dc_lv[:, ci], qp_c, ls4)  # [n,2,2]
        c = chroma_ac[:, ci].reshape(n * 4, 4, 4)
        c = c.at[:, 0, 0].set(dcv.reshape(n * 4))
        d = dequant4(c, jnp.repeat(qp_c, 4), ls4,
                     dc_passthrough_mask=jnp.ones(n * 4, dtype=bool))
        r = idct4(d).reshape(n, 2, 2, 4, 4)
        outs.append(r.transpose(0, 1, 3, 2, 4).reshape(n, 8, 8))
    return jnp.stack(outs, axis=1)


# ---------------------------------------------------------------------------
# Lane-major fast path.
#
# The block-major layout above keeps 4x4 blocks in the trailing dims.  The
# fast path transposes once to (coef-row, block-lane) = (16, B) / (64, B)
# and expresses each separable IDCT direction as ONE exact matmul: the
# butterfly's interior floor-shifts ((x>>1), (x>>2) —
# reference transform.rs:159-187, pred8x8.rs:85-147) are hoisted into
# explicitly shifted helper rows appended to the input ("augmented matrix"),
# and the within-block transpose between directions is folded into the
# matrix as a permutation.  f32 matmuls are exact here: conformant streams
# bound dequantized coefficients to +-2^15 (spec 8.5.12.1), so all
# accumulations stay below 2^24.
# ---------------------------------------------------------------------------


def _perm44():
    P = np.zeros((16, 16), np.float32)
    for y in range(4):
        for x in range(4):
            P[4 * x + y, 4 * y + x] = 1
    return P


def _perm88():
    P = np.zeros((64, 64), np.float32)
    for y in range(8):
        for x in range(8):
            P[8 * x + y, 8 * y + x] = 1
    return P


def _idct4_mat():
    """M (16, 24): one direction of the 4x4 butterfly + within-block
    transpose.  Input rows: [c(16); c[4:8]>>1; c[12:16]>>1]."""
    # A6: out_y' from [d0, d1, d2, d3, d1>>1, d3>>1]
    A6 = np.array([
        [1, 1, 1, 0, 0, 1],
        [1, 0, -1, -1, 1, 0],
        [1, 0, -1, 1, -1, 0],
        [1, -1, 1, 0, 0, -1],
    ], np.float32)
    K = np.zeros((16, 24), np.float32)
    for yo in range(4):
        for x in range(4):
            for yi in range(4):
                K[4 * yo + x, 4 * yi + x] = A6[yo, yi]
            K[4 * yo + x, 16 + x] = A6[yo, 4]
            K[4 * yo + x, 20 + x] = A6[yo, 5]
    return K


def _idct8_mats():
    """(KE (64,112), MF (64,96)): one direction of the 8.5.13.1 8x8
    butterfly as two matmuls.  KE input rows: [c(64); (c1,c2,c3,c5,c6,c7
    rows)>>1 (48)]; MF input rows: [e(64); (e1,e3,e5,e7 rows)>>2 (32)],
    with the within-block transpose folded into MF."""
    # e from [c0..c7, c1h, c2h, c3h, c5h, c6h, c7h]
    E = np.zeros((8, 14), np.float32)
    E[0, 0] = E[0, 4] = 1                                  # c0 + c4
    E[1, 3] = -1; E[1, 5] = 1; E[1, 7] = -1; E[1, 13] = -1  # -c3+c5-c7-c7h
    E[2, 0] = 1; E[2, 4] = -1                              # c0 - c4
    E[3, 1] = 1; E[3, 7] = 1; E[3, 3] = -1; E[3, 10] = -1  # c1+c7-c3-c3h
    E[4, 9] = 1; E[4, 6] = -1                              # c2h - c6
    E[5, 1] = -1; E[5, 7] = 1; E[5, 5] = 1; E[5, 11] = 1   # -c1+c7+c5+c5h
    E[6, 2] = 1; E[6, 12] = 1                              # c2 + c6h
    E[7, 3] = 1; E[7, 5] = 1; E[7, 1] = 1; E[7, 8] = 1     # c3+c5+c1+c1h
    # f from [e0..e7, e1q, e3q, e5q, e7q]
    F = np.zeros((8, 12), np.float32)
    F[0, 0] = F[0, 6] = 1                   # e0 + e6
    F[1, 1] = 1; F[1, 11] = 1               # e1 + e7q
    F[2, 2] = F[2, 4] = 1                   # e2 + e4
    F[3, 3] = 1; F[3, 10] = 1               # e3 + e5q
    F[4, 2] = 1; F[4, 4] = -1               # e2 - e4
    F[5, 9] = 1; F[5, 5] = -1               # e3q - e5
    F[6, 0] = 1; F[6, 6] = -1               # e0 - e6
    F[7, 7] = 1; F[7, 8] = -1               # e7 - e1q
    # final recombination g (the stage() return order)
    G = np.zeros((8, 8), np.float32)
    for k, (i, j, s) in enumerate([(0, 7, 1), (2, 5, 1), (4, 3, 1),
                                   (6, 1, 1), (6, 1, -1), (4, 3, -1),
                                   (2, 5, -1), (0, 7, -1)]):
        G[k, i] = 1
        G[k, j] = s
    GF = G @ F                              # (8, 12)

    def blow(M, nsh):
        """Lift an 8-dim row matrix to the 64-dim p=8*major+x space."""
        K = np.zeros((64, 64 + 8 * nsh), np.float32)
        for mo in range(8):
            for x in range(8):
                for mi in range(8):
                    K[8 * mo + x, 8 * mi + x] = M[mo, mi]
                for j in range(nsh):
                    K[8 * mo + x, 64 + 8 * j + x] = M[mo, 8 + j]
        return K

    KE = blow(E, 6)                         # (64, 112)
    KF = blow(GF, 4)                        # (64, 96)
    return KE, KF


_M4DIR = _idct4_mat()
_KE8, _MF8 = _idct8_mats()
_P44 = _perm44()
_P88 = _perm88()
_KH16 = np.kron(np.asarray(HAD4), np.asarray(HAD4)).astype(np.float32)
_KH4 = np.kron(np.asarray(HAD2), np.asarray(HAD2)).astype(np.float32)
# z-scan -> raster block order (and inverse) for the 16 4x4 luma blocks
_Z2P = np.array([4 * y + x for (x, y) in ZSCAN_4X4_POS], np.int32)
_RASTER2Z = np.argsort(_Z2P).astype(np.int32)


def _mm_i(M, X):
    """Exact int matmul in f32 (|acc| < 2^24).

    Precision.HIGHEST forces full-f32 products; a default-precision dot
    may round its inputs (bf16 or TF32), which breaks 12+-bit integers."""
    acc = jax.lax.dot_general(jnp.asarray(M), X.astype(jnp.float32),
                              (((1,), (0,)), ((), ())),
                              precision=jax.lax.Precision.HIGHEST,
                              preferred_element_type=jnp.float32)
    return acc.astype(jnp.int32)


def _ls_rows(ls, qp, ncoef):
    """LS[p, b] = ls[qp[b] % 6, p] via a one-hot matmul (exact)."""
    flat = jnp.asarray(ls).reshape(6, ncoef).T.astype(jnp.float32)
    oh = (jax.lax.broadcasted_iota(jnp.int32, (6, qp.shape[0]), 0)
          == (qp % 6)[None]).astype(jnp.float32)
    return jax.lax.dot_general(flat, oh, (((1,), (0,)), ((), ())),
                               precision=jax.lax.Precision.HIGHEST) \
        .astype(jnp.int32)


def dequant4_lanes(C, qp, ls4, dc_pass=None):
    """C (16, B) int32 coefficient rows, qp (B,) -> D (16, B)."""
    shift = (qp // 6)[None]
    prod = C * _ls_rows(ls4, qp, 16)
    hi = prod << jnp.maximum(shift - 4, 0)
    rnd = 1 << jnp.clip(3 - shift, 0, 3)
    lo = (prod + rnd) >> jnp.maximum(4 - shift, 0)
    D = jnp.where((qp >= 24)[None], hi, lo)
    if dc_pass is not None:
        D = jnp.concatenate([jnp.where(dc_pass[None], C[0:1], D[0:1]),
                             D[1:]], axis=0)
    return D


def dequant8_lanes(C, qp, ls8):
    shift = (qp // 6)[None]
    prod = C * _ls_rows(ls8, qp, 64)
    hi = prod << jnp.maximum(shift - 6, 0)
    rnd = 1 << jnp.clip(5 - shift, 0, 5)
    lo = (prod + rnd) >> jnp.maximum(6 - shift, 0)
    return jnp.where((qp >= 36)[None], hi, lo)


def idct4_lanes(D):
    """D (16, B) -> r (16, B); two augmented-matmul directions.

    Each direction first transposes within the block (perm matmul) then
    transforms the major coordinate, matching the normative x-then-y order
    (the interior floor-shifts make direction order bit-significant)."""
    def one_dir(X):
        Xp = _mm_i(_P44, X)
        aug = jnp.concatenate([Xp, Xp[4:8] >> 1, Xp[12:16] >> 1], axis=0)
        return _mm_i(_M4DIR, aug)
    return (one_dir(one_dir(D)) + 32) >> 6


def idct8_lanes(D):
    def one_dir(X):
        Xp = _mm_i(_P88, X)
        sh1 = jnp.concatenate([Xp[8:16], Xp[16:24], Xp[24:32], Xp[40:48],
                               Xp[48:56], Xp[56:64]], axis=0) >> 1
        e = _mm_i(_KE8, jnp.concatenate([Xp, sh1], axis=0))
        sh2 = jnp.concatenate([e[8:16], e[24:32], e[40:48], e[56:64]],
                              axis=0) >> 2
        return _mm_i(_MF8, jnp.concatenate([e, sh2], axis=0))
    return (one_dir(one_dir(D)) + 32) >> 6


def i16_dc_lanes(dc, qp, ls4):
    """dc (16, n) raster DC rows -> scaled DC values (16, n)."""
    f = _mm_i(_KH16, dc)
    ls00 = jnp.asarray(ls4).reshape(6, 16)[qp % 6, 0][None]
    shift = (qp // 6)[None]
    hi = (f * ls00) << jnp.maximum(shift - 6, 0)
    rnd = 1 << jnp.clip(5 - shift, 0, 5)
    lo = (f * ls00 + rnd) >> jnp.maximum(6 - shift, 0)
    return jnp.where(shift >= 6, hi, lo)


def chroma_dc_lanes(dc, qp, ls4):
    """dc (4, n) raster 2x2 DC rows -> scaled (4, n)."""
    f = _mm_i(_KH4, dc)
    ls00 = jnp.asarray(ls4).reshape(6, 16)[qp % 6, 0][None]
    return ((f * ls00) << (qp // 6)[None]) >> 5


def luma_residual_tiles(kind, qp_y, luma4, luma8, luma_dc, n, ls4, ls8):
    """Per-MB residual tiles [n,16,16] int32 for all non-PCM MBs.

    kind [n], qp_y [n], luma4 [n,16,4,4] (z order), luma8 [n,4,8,8],
    luma_dc [n,4,4].  Lane-major implementation; bit-identical to
    luma_residual_tiles_ref (asserted in tests/test_jax_pipeline.py)."""
    is16 = kind == KIND_I16
    B = n * 16
    C4 = luma4.reshape(B, 16).T                      # (16, B)
    # I16: scaled DC values replace the per-block DC before IDCT
    dcv = i16_dc_lanes(luma_dc.reshape(n, 16).T, qp_y, ls4)   # (16, n)
    dc_row = dcv[jnp.asarray(_Z2P)].T.reshape(1, B)  # z-minor lanes
    m16 = jnp.repeat(is16, 16)[None]
    C4 = jnp.concatenate([jnp.where(m16, dc_row, C4[0:1]), C4[1:]], axis=0)
    D4 = dequant4_lanes(C4, jnp.repeat(qp_y, 16), ls4,
                        dc_pass=jnp.repeat(is16, 16))
    R4 = idct4_lanes(D4)                             # (16, B)
    R8 = idct8_lanes(dequant8_lanes(luma8.reshape(n * 4, 64).T,
                                    jnp.repeat(qp_y, 4), ls8))
    t4 = R4.T.reshape(n, 16, 4, 4)[:, jnp.asarray(_RASTER2Z)] \
        .reshape(n, 4, 4, 4, 4).transpose(0, 1, 3, 2, 4).reshape(n, 16, 16)
    t8 = R8.T.reshape(n, 2, 2, 8, 8).transpose(0, 1, 3, 2, 4) \
        .reshape(n, 16, 16)
    return jnp.where((kind == KIND_I8)[:, None, None], t8, t4)


def chroma_residual_tiles(qp_cb, qp_cr, chroma_dc_lv, chroma_ac, n,
                          ls4cb, ls4cr):
    """Both chroma components: chroma_dc_lv [n,2,2,2], chroma_ac
    [n,2,4,4,4] -> tiles [n,2,8,8].  Lane-major implementation."""
    outs = []
    for ci, (qp_c, ls4) in enumerate(((qp_cb, ls4cb), (qp_cr, ls4cr))):
        dcv = chroma_dc_lanes(chroma_dc_lv[:, ci].reshape(n, 4).T,
                              qp_c, ls4)             # (4, n)
        C = chroma_ac[:, ci].reshape(n * 4, 16).T    # (16, 4n)
        dc_row = dcv.T.reshape(1, n * 4)
        C = jnp.concatenate([dc_row, C[1:]], axis=0)
        D = dequant4_lanes(C, jnp.repeat(qp_c, 4), ls4,
                           dc_pass=jnp.ones(n * 4, dtype=bool))
        r = idct4_lanes(D)
        outs.append(r.T.reshape(n, 2, 2, 4, 4).transpose(0, 1, 3, 2, 4)
                    .reshape(n, 8, 8))
    return jnp.stack(outs, axis=1)
