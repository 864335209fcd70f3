"""Vectorized intra predictors for the wavefront kernel.

Batched over K macroblocks: every mode is computed branchlessly (position
formulas unrolled at trace time from the same spec equations as
refimpl.intra) and the per-MB mode selects via one-hot.  Exact int32.
"""
from __future__ import annotations

from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np

# float dots below carry exact small integers (|acc| < 2^24); HIGHEST
# keeps them in full f32 (no TF32 input rounding) on every backend
_HI = jax.lax.Precision.HIGHEST


def _mode_select(vals, mode, n_modes):
    """vals [K, M, P], mode [K] -> [K, P] via one-hot multiply-add."""
    oh = (jnp.arange(n_modes, dtype=jnp.int32)[None, :] ==
          mode[:, None]).astype(vals.dtype)
    return jnp.einsum("km,kmp->kp", oh, vals)


@lru_cache(maxsize=None)
def _mat4():
    # cache numpy only: jnp constants created during tracing would leak
    from .pred_tables import tables_4x4, to_matrix
    IDX, W, R, S = tables_4x4()
    return to_matrix(IDX, W, 13), R.reshape(-1), S.reshape(-1)


def pred4x4_fast(mode, above, left, corner, avail_a, avail_b, bitdepth=8):
    """Matrix-form 4x4 prediction: one [K,13]x[13,144] matmul evaluates all
    directional modes (exact in f32); DC computed separately; per-MB select.

    mode [K]; above [K,8] (above-right substituted); left [K,4]; corner [K]
    -> [K,4,4].  Bit-identical to pred4x4_batch (verified in tests)."""
    M, R, S = (jnp.asarray(t) for t in _mat4())
    s = jnp.concatenate([corner[:, None], above, left], axis=1)  # [K,13]
    acc = jnp.dot(s.astype(jnp.float32), M, precision=_HI,
                  preferred_element_type=jnp.float32)
    vals = ((acc.astype(jnp.int32) + R) >> S).reshape(-1, 9, 16)
    sel = _mode_select(vals, mode.astype(jnp.int32), 9)
    # DC (mode 2)
    suma = jnp.sum(above[:, :4], axis=1)
    suml = jnp.sum(left, axis=1)
    dc = jnp.where(avail_a & avail_b, (suma + suml + 4) >> 3,
                   jnp.where(avail_a, (suml + 2) >> 2,
                             jnp.where(avail_b, (suma + 2) >> 2,
                                       jnp.full_like(suma,
                                                     1 << (bitdepth - 1)))))
    out = jnp.where((mode == 2)[:, None], dc[:, None], sel)
    return out.reshape(-1, 4, 4)


@lru_cache(maxsize=None)
def _mat8():
    from .pred_tables import tables_8x8, to_matrix
    IDX, W, R, S = tables_8x8()
    return to_matrix(IDX, W, 25), R.reshape(-1), S.reshape(-1)


def pred8x8_fast(mode, above, left, corner, avail_a, avail_b, bitdepth=8):
    """Matrix-form 8x8 prediction on FILTERED samples.

    above [K,16], left [K,8], corner [K] -> [K,8,8]."""
    M, R, S = (jnp.asarray(t) for t in _mat8())
    s = jnp.concatenate([corner[:, None], above, left], axis=1)  # [K,25]
    acc = jnp.dot(s.astype(jnp.float32), M, precision=_HI,
                  preferred_element_type=jnp.float32)
    vals = ((acc.astype(jnp.int32) + R) >> S).reshape(-1, 9, 64)
    sel = _mode_select(vals, mode.astype(jnp.int32), 9)
    suma = jnp.sum(above[:, :8], axis=1)
    suml = jnp.sum(left, axis=1)
    dc = jnp.where(avail_a & avail_b, (suma + suml + 8) >> 4,
                   jnp.where(avail_a, (suml + 4) >> 3,
                             jnp.where(avail_b, (suma + 4) >> 3,
                                       jnp.full_like(suma,
                                                     1 << (bitdepth - 1)))))
    out = jnp.where((mode == 2)[:, None], dc[:, None], sel)
    return out.reshape(-1, 8, 8)


@lru_cache(maxsize=None)
def _fmat8():
    from .pred_tables import filter_tables_8x8, to_matrix
    (I1, W1, _, _), (I0, W0, _, _) = filter_tables_8x8()
    return to_matrix(I1[None], W1[None], 25), to_matrix(I0[None], W0[None], 25)


def filter8x8_fast(above, left, corner, avail_a, avail_b, avail_d):
    """Matrix-form reference filter (8.3.2.2.1): returns (fa [K,16],
    fl [K,8], fz [K])."""
    M1, M0 = (jnp.asarray(t) for t in _fmat8())
    s = jnp.concatenate([corner[:, None], above, left], axis=1)  # [K,25]
    sf = s.astype(jnp.float32)
    f_d = (jnp.dot(sf, M1, precision=_HI, preferred_element_type=jnp.float32)
           .astype(jnp.int32) + 2) >> 2
    f_nd = (jnp.dot(sf, M0, precision=_HI,
                    preferred_element_type=jnp.float32)
            .astype(jnp.int32) + 2) >> 2
    f = jnp.where(avail_d[:, None], f_d, f_nd)
    a0, l0, z = above[:, 0], left[:, 0], corner
    fz = jnp.where(avail_a & avail_b, (a0 + 2 * z + l0 + 2) >> 2,
                   jnp.where(avail_b, (3 * z + a0 + 2) >> 2,
                             jnp.where(avail_a, (3 * z + l0 + 2) >> 2, z)))
    fz = jnp.where(avail_d, fz, z)
    fa = jnp.where(avail_b[:, None], f[:, 1:17], above)
    fl = jnp.where(avail_a[:, None], f[:, 17:25], left)
    return fa, fl, fz


def _sel(preds, mode, n_modes):
    """preds: list of [K,...]; mode: [K] -> [K,...]."""
    stack = jnp.stack(preds)  # [M,K,...]
    onehot = (jnp.arange(n_modes, dtype=jnp.int32)[:, None] ==
              mode[None, :]).astype(jnp.int32)
    oh = onehot.reshape(onehot.shape + (1,) * (stack.ndim - 2))
    return jnp.sum(stack * oh, axis=0)


def pred4x4_batch(mode, above, left, corner, avail_a, avail_b, bitdepth=8):
    """mode [K]; above [K,8] (above-right already substituted); left [K,4];
    corner [K]; avail_* [K] bool -> [K,4,4]."""
    K = above.shape[0]
    a = [above[:, i] for i in range(8)]
    l = [left[:, i] for i in range(4)]
    z = corner
    zero = jnp.zeros_like(z)

    def grid(fn):
        rows = [jnp.stack([fn(y, x) for x in range(4)], axis=-1)
                for y in range(4)]
        return jnp.stack(rows, axis=-2)

    p_v = grid(lambda y, x: a[x])
    p_h = grid(lambda y, x: l[y])
    # DC with availability fallback
    suma = a[0] + a[1] + a[2] + a[3]
    suml = l[0] + l[1] + l[2] + l[3]
    both = (suma + suml + 4) >> 3
    onlyl = (suml + 2) >> 2
    onlya = (suma + 2) >> 2
    dcdef = jnp.full_like(z, 1 << (bitdepth - 1))
    dc = jnp.where(avail_a & avail_b, both,
                   jnp.where(avail_a, onlyl,
                             jnp.where(avail_b, onlya, dcdef)))
    p_dc = grid(lambda y, x: dc)

    def ddl(y, x):
        if x == 3 and y == 3:
            return (a[6] + 3 * a[7] + 2) >> 2
        i = x + y
        return (a[i] + 2 * a[i + 1] + a[i + 2] + 2) >> 2
    p_ddl = grid(ddl)

    def ddr(y, x):
        if x > y:
            i = x - y
            s2 = a[i - 2] if i >= 2 else z
            return (s2 + 2 * a[i - 1] + a[i] + 2) >> 2
        if x < y:
            i = y - x
            s2 = l[i - 2] if i >= 2 else z
            return (s2 + 2 * l[i - 1] + l[i] + 2) >> 2
        return (a[0] + 2 * z + l[0] + 2) >> 2
    p_ddr = grid(ddr)

    def vr(y, x):
        zvr = 2 * x - y
        if zvr >= 0 and zvr % 2 == 0:
            i = x - (y >> 1)
            return ((z if i == 0 else a[i - 1]) + a[i] + 1) >> 1
        if zvr >= 0:
            i = x - (y >> 1)
            s0 = a[i - 2] if i >= 2 else z
            s1 = a[i - 1] if i >= 1 else z
            return (s0 + 2 * s1 + a[i] + 2) >> 2
        if zvr == -1:
            return (l[0] + 2 * z + a[0] + 2) >> 2
        s3 = l[y - 3] if y >= 3 else z
        return (l[y - 1] + 2 * l[y - 2] + s3 + 2) >> 2
    p_vr = grid(vr)

    def hd(y, x):
        zhd = 2 * y - x
        if zhd >= 0 and zhd % 2 == 0:
            i = y - (x >> 1)
            return ((z if i == 0 else l[i - 1]) + l[i] + 1) >> 1
        if zhd >= 0:
            i = y - (x >> 1)
            s0 = l[i - 2] if i >= 2 else z
            s1 = l[i - 1] if i >= 1 else z
            return (s0 + 2 * s1 + l[i] + 2) >> 2
        if zhd == -1:
            return (a[0] + 2 * z + l[0] + 2) >> 2
        s3 = a[x - 3] if x >= 3 else z
        return (a[x - 1] + 2 * a[x - 2] + s3 + 2) >> 2
    p_hd = grid(hd)

    def vl(y, x):
        i = x + (y >> 1)
        if y % 2 == 0:
            return (a[i] + a[i + 1] + 1) >> 1
        return (a[i] + 2 * a[i + 1] + a[i + 2] + 2) >> 2
    p_vl = grid(vl)

    def hu(y, x):
        zhu = x + 2 * y
        if zhu < 5 and zhu % 2 == 0:
            i = y + (x >> 1)
            return (l[i] + l[i + 1] + 1) >> 1
        if zhu < 5:
            i = y + (x >> 1)
            return (l[i] + 2 * l[i + 1] + l[i + 2] + 2) >> 2
        if zhu == 5:
            return (l[2] + 3 * l[3] + 2) >> 2
        return l[3]
    p_hu = grid(hu)

    return _sel([p_v, p_h, p_dc, p_ddl, p_ddr, p_vr, p_hd, p_vl, p_hu],
                mode, 9)


def filter8x8_batch(above, left, corner, avail_a, avail_b, avail_d):
    """Reference-sample low-pass for 8x8 (spec 8.3.2.2.1), batched.

    above [K,16] (above-right substituted), left [K,8], corner [K]."""
    a = [above[:, i] for i in range(16)]
    l = [left[:, i] for i in range(8)]
    z = corner
    fa = []
    fa.append(jnp.where(avail_d, (z + 2 * a[0] + a[1] + 2) >> 2,
                        (3 * a[0] + a[1] + 2) >> 2))
    for x in range(1, 15):
        fa.append((a[x - 1] + 2 * a[x] + a[x + 1] + 2) >> 2)
    fa.append((a[14] + 3 * a[15] + 2) >> 2)
    fabove = jnp.where(avail_b[:, None], jnp.stack(fa, axis=-1), above)

    fz = jnp.where(avail_a & avail_b, (a[0] + 2 * z + l[0] + 2) >> 2,
                   jnp.where(avail_b, (3 * z + a[0] + 2) >> 2,
                             jnp.where(avail_a, (3 * z + l[0] + 2) >> 2, z)))
    fcorner = jnp.where(avail_d, fz, z)

    fl = []
    fl.append(jnp.where(avail_d, (z + 2 * l[0] + l[1] + 2) >> 2,
                        (3 * l[0] + l[1] + 2) >> 2))
    for y in range(1, 7):
        fl.append((l[y - 1] + 2 * l[y] + l[y + 1] + 2) >> 2)
    fl.append((l[6] + 3 * l[7] + 2) >> 2)
    fleft = jnp.where(avail_a[:, None], jnp.stack(fl, axis=-1), left)
    return fabove, fleft, fcorner


def pred8x8_batch(mode, above, left, corner, avail_a, avail_b, bitdepth=8):
    """Prediction on FILTERED samples: above [K,16], left [K,8], corner [K]."""
    a = [above[:, i] for i in range(16)]
    l = [left[:, i] for i in range(8)]
    z = corner

    def grid(fn):
        rows = [jnp.stack([fn(y, x) for x in range(8)], axis=-1)
                for y in range(8)]
        return jnp.stack(rows, axis=-2)

    p_v = grid(lambda y, x: a[x])
    p_h = grid(lambda y, x: l[y])
    suma = sum(a[:8])
    suml = sum(l)
    dc = jnp.where(avail_a & avail_b, (suma + suml + 8) >> 4,
                   jnp.where(avail_a, (suml + 4) >> 3,
                             jnp.where(avail_b, (suma + 4) >> 3,
                                       jnp.full_like(z, 1 << (bitdepth - 1)))))
    p_dc = grid(lambda y, x: dc)

    def ddl(y, x):
        if x == 7 and y == 7:
            return (a[14] + 3 * a[15] + 2) >> 2
        i = x + y
        return (a[i] + 2 * a[i + 1] + a[i + 2] + 2) >> 2
    p_ddl = grid(ddl)

    def ddr(y, x):
        if x > y:
            i = x - y
            s2 = a[i - 2] if i >= 2 else z
            return (s2 + 2 * a[i - 1] + a[i] + 2) >> 2
        if x < y:
            i = y - x
            s2 = l[i - 2] if i >= 2 else z
            s1 = l[i - 1] if i >= 1 else z
            return (s2 + 2 * s1 + l[i] + 2) >> 2
        return (a[0] + 2 * z + l[0] + 2) >> 2
    p_ddr = grid(ddr)

    def vr(y, x):
        zvr = 2 * x - y
        if zvr >= 0 and zvr % 2 == 0:
            i = x - (y >> 1)
            return ((z if i == 0 else a[i - 1]) + a[i] + 1) >> 1
        if zvr >= 0:
            i = x - (y >> 1)
            s0 = a[i - 2] if i >= 2 else z
            s1 = a[i - 1] if i >= 1 else z
            return (s0 + 2 * s1 + a[i] + 2) >> 2
        if zvr == -1:
            return (l[0] + 2 * z + a[0] + 2) >> 2
        i = y - 2 * x
        s3 = l[i - 3] if i >= 3 else z
        return (l[i - 1] + 2 * l[i - 2] + s3 + 2) >> 2
    p_vr = grid(vr)

    def hd(y, x):
        zhd = 2 * y - x
        if zhd >= 0 and zhd % 2 == 0:
            i = y - (x >> 1)
            return ((z if i == 0 else l[i - 1]) + l[i] + 1) >> 1
        if zhd >= 0:
            i = y - (x >> 1)
            s0 = l[i - 2] if i >= 2 else z
            s1 = l[i - 1] if i >= 1 else z
            return (s0 + 2 * s1 + l[i] + 2) >> 2
        if zhd == -1:
            return (a[0] + 2 * z + l[0] + 2) >> 2
        i = x - 2 * y
        s3 = a[i - 3] if i >= 3 else z
        return (a[i - 1] + 2 * a[i - 2] + s3 + 2) >> 2
    p_hd = grid(hd)

    def vl(y, x):
        i = x + (y >> 1)
        if y % 2 == 0:
            return (a[i] + a[i + 1] + 1) >> 1
        return (a[i] + 2 * a[i + 1] + a[i + 2] + 2) >> 2
    p_vl = grid(vl)

    def hu(y, x):
        zhu = x + 2 * y
        if zhu < 13 and zhu % 2 == 0:
            i = y + (x >> 1)
            return (l[i] + l[i + 1] + 1) >> 1
        if zhu < 13:
            i = y + (x >> 1)
            return (l[i] + 2 * l[i + 1] + l[i + 2] + 2) >> 2
        if zhu == 13:
            return (l[6] + 3 * l[7] + 2) >> 2
        return l[7]
    p_hu = grid(hu)

    return _sel([p_v, p_h, p_dc, p_ddl, p_ddr, p_vr, p_hd, p_vl, p_hu],
                mode, 9)


def pred16x16_batch(mode, above, left, corner, avail_a, avail_b, avail_d,
                    bitdepth=8):
    """mode [K] (0 V, 1 H, 2 DC, 3 Plane); above [K,16]; left [K,16]."""
    K = above.shape[0]
    p_v = jnp.broadcast_to(above[:, None, :], (K, 16, 16))
    p_h = jnp.broadcast_to(left[:, :, None], (K, 16, 16))
    suma = jnp.sum(above, axis=1)
    suml = jnp.sum(left, axis=1)
    dc = jnp.where(avail_a & avail_b, (suma + suml + 16) >> 5,
                   jnp.where(avail_a, (suml + 8) >> 4,
                             jnp.where(avail_b, (suma + 8) >> 4,
                                       jnp.full_like(suma, 1 << (bitdepth - 1)))))
    p_dc = jnp.broadcast_to(dc[:, None, None], (K, 16, 16))
    # plane
    z = corner
    hh = sum((x + 1) * (above[:, 8 + x] -
                        (above[:, 6 - x] if x < 7 else z)) for x in range(8))
    vv = sum((y + 1) * (left[:, 8 + y] -
                        (left[:, 6 - y] if y < 7 else z)) for y in range(8))
    b = (5 * hh + 32) >> 6
    c = (5 * vv + 32) >> 6
    aa = 16 * (above[:, 15] + left[:, 15])
    xs = jnp.arange(16, dtype=jnp.int32)
    grid_val = (aa[:, None, None] + b[:, None, None] * (xs[None, None, :] - 7)
                + c[:, None, None] * (xs[None, :, None] - 7) + 16) >> 5
    p_pl = jnp.clip(grid_val, 0, (1 << bitdepth) - 1)
    return _sel([p_v, p_h, p_dc, p_pl], mode, 4)


def pred_chroma_batch(mode, above, left, corner, avail_a, avail_b, avail_d,
                      bitdepth=8):
    """4:2:0 chroma: mode [K] (0 DC, 1 H, 2 V, 3 Plane); above/left [K,8]."""
    K = above.shape[0]
    p_h = jnp.broadcast_to(left[:, :, None], (K, 8, 8))
    p_v = jnp.broadcast_to(above[:, None, :], (K, 8, 8))
    default = 1 << (bitdepth - 1)
    # per-quadrant DC (spec 8.3.4.1)
    quads = []
    for by in (0, 4):
        row = []
        for bx in (0, 4):
            asum = above[:, bx:bx + 4].sum(axis=1)
            lsum = left[:, by:by + 4].sum(axis=1)
            if (bx == 0 and by == 0) or (bx > 0 and by > 0):
                v = jnp.where(avail_a & avail_b, (asum + lsum + 4) >> 3,
                              jnp.where(avail_a, (lsum + 2) >> 2,
                                        jnp.where(avail_b, (asum + 2) >> 2,
                                                  default)))
            elif bx > 0:  # top-right quadrant: prefer above
                v = jnp.where(avail_b, (asum + 2) >> 2,
                              jnp.where(avail_a, (lsum + 2) >> 2, default))
            else:  # bottom-left: prefer left
                v = jnp.where(avail_a, (lsum + 2) >> 2,
                              jnp.where(avail_b, (asum + 2) >> 2, default))
            row.append(v)
        quads.append(row)
    p_dc = jnp.zeros((K, 8, 8), dtype=above.dtype)
    for qi, by in enumerate((0, 4)):
        for qj, bx in enumerate((0, 4)):
            p_dc = p_dc.at[:, by:by + 4, bx:bx + 4].set(
                jnp.broadcast_to(quads[qi][qj][:, None, None], (K, 4, 4)))
    # plane
    z = corner
    hsum = sum((x + 1) * (above[:, 4 + x] -
                          (above[:, 2 - x] if x <= 2 else z)) for x in range(4))
    vsum = sum((y + 1) * (left[:, 4 + y] -
                          (left[:, 2 - y] if y <= 2 else z)) for y in range(4))
    b = (34 * hsum + 32) >> 6
    c = (34 * vsum + 32) >> 6
    aa = 16 * (above[:, 7] + left[:, 7])
    xs = jnp.arange(8, dtype=jnp.int32)
    val = (aa[:, None, None] + b[:, None, None] * (xs[None, None, :] - 3)
           + c[:, None, None] * (xs[None, :, None] - 3) + 16) >> 5
    p_pl = jnp.clip(val, 0, (1 << bitdepth) - 1)
    return _sel([p_dc, p_h, p_v, p_pl], mode, 4)
