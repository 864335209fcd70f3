"""Device motion compensation (spec 8.4.2) — batched over every 4x4 block.

Inter prediction has no intra-frame neighbor dependency (it reads
reference pictures only), so unlike intra it vectorizes completely: one
gather fetches a 9x9 reference window per 4x4 block (edge-clamped), the
6-tap half-pel lattice (b/h/j) is computed for all blocks at once, and
the 16 quarter-pel phases resolve branchlessly per block.  Chroma is the
eighth-pel bilinear on 3x3 windows.  The weighted-prediction combine
(8.4.2.3, default / explicit / implicit) is unified into per-block
(w0, o0, w1, o1, logWD) parameters resolved host-side.

Exact int32 mirror of refimpl/inter.py:luma_interp/chroma_interp (which
is bit-exact vs libavcodec).  The upstream reference decoder parses inter
syntax but has no inter reconstruction at all (todo!, frame/mod.rs:88).

Motion vectors themselves are derived on host (native recon.cc in
motion_only mode): MV prediction is a neighbor-chained integer recurrence
— the same serial shape as CABAC — while MC is where the pixel work is.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np


def _tap6(v0, v1, v2, v3, v4, v5):
    return v0 - 5 * v1 + 20 * v2 + 20 * v3 - 5 * v4 + v5


def _avg(a, b):
    return (a + b + 1) >> 1


def _clip255(v):
    return jnp.clip(v, 0, 255)


def mc_luma_blocks(ref_flat, rs, mv, bx4, by4, H, W):
    """Quarter-pel MC for all 4x4 luma blocks of one list.

    ref_flat: [R*H*W] int32 flattened reference stack; rs [n4] stack slot
    (clipped to valid; mask invalid blocks downstream); mv [n4,2]
    quarter-pel; bx4/by4 [n4] block coordinates (in 4x4 units).
    Returns [n4,4,4] int32 predictions (one elementwise flat gather of
    n4*81 samples)."""
    mvx, mvy = mv[:, 0], mv[:, 1]
    bx = bx4 * 4 + (mvx >> 2) - 2
    by = by4 * 4 + (mvy >> 2) - 2
    rows = jnp.clip(by[:, None] + jnp.arange(9, dtype=jnp.int32), 0, H - 1)
    cols = jnp.clip(bx[:, None] + jnp.arange(9, dtype=jnp.int32), 0, W - 1)
    base = rs * (H * W)
    flat = (base[:, None, None] + rows[:, :, None] * W + cols[:, None, :])
    win = ref_flat[flat.reshape(-1)].reshape(-1, 9, 9)  # [n4,9,9]

    # 6-tap lattice (names match refimpl/inter.py:luma_interp)
    bmat = _tap6(win[:, :, 0:4], win[:, :, 1:5], win[:, :, 2:6],
                 win[:, :, 3:7], win[:, :, 4:8], win[:, :, 5:9])  # [n4,9,4]
    b = (bmat + 16) >> 5
    hmat = _tap6(win[:, 0:4, :], win[:, 1:5, :], win[:, 2:6, :],
                 win[:, 3:7, :], win[:, 4:8, :], win[:, 5:9, :])  # [n4,4,9]
    hh = (hmat + 16) >> 5
    jmat = _tap6(bmat[:, 0:4, :], bmat[:, 1:5, :], bmat[:, 2:6, :],
                 bmat[:, 3:7, :], bmat[:, 4:8, :], bmat[:, 5:9, :])
    jC = _clip255((jmat + 512) >> 10)                             # [n4,4,4]

    G = win[:, 2:6, 2:6]
    Hs = win[:, 2:6, 3:7]
    M = win[:, 3:7, 2:6]
    bC = _clip255(b[:, 2:6, :])
    bD = _clip255(b[:, 3:7, :])
    hC = _clip255(hh[:, :, 2:6])
    hE = _clip255(hh[:, :, 3:7])

    fx = (mvx & 3)[:, None, None]
    fy = (mvy & 3)[:, None, None]

    # Table 8-12 phase selection, branchless
    row0 = jnp.where(fx == 0, G,
           jnp.where(fx == 1, _avg(G, bC),
           jnp.where(fx == 2, bC, _avg(bC, Hs))))
    row2 = jnp.where(fx == 0, hC,
           jnp.where(fx == 1, _avg(hC, jC),
           jnp.where(fx == 2, jC, _avg(jC, hE))))
    bsel = jnp.where(fy == 1, bC, bD)
    hsel = jnp.where(fx == 1, hC, hE)
    diag = _avg(bsel, hsel)
    row1 = jnp.where(fx == 0, _avg(G, hC),
           jnp.where(fx == 2, _avg(bC, jC), diag))
    row3 = jnp.where(fx == 0, _avg(hC, M),
           jnp.where(fx == 2, _avg(jC, bD), diag))
    return jnp.where(fy == 0, row0,
           jnp.where(fy == 1, row1,
           jnp.where(fy == 2, row2, row3)))


def mc_chroma_blocks(ref_flat, rs, mv, bx4, by4, Hc, Wc):
    """Eighth-pel bilinear chroma MC for the 2x2 chroma block co-located
    with each luma 4x4 block (4:2:0).  ref_flat [R*Hc*Wc] one plane's
    stack; returns [n4,2,2] int32."""
    mvx, mvy = mv[:, 0], mv[:, 1]
    bx = bx4 * 2 + (mvx >> 3)
    by = by4 * 2 + (mvy >> 3)
    rows = jnp.clip(by[:, None] + jnp.arange(3, dtype=jnp.int32), 0, Hc - 1)
    cols = jnp.clip(bx[:, None] + jnp.arange(3, dtype=jnp.int32), 0, Wc - 1)
    base = rs * (Hc * Wc)
    flat = (base[:, None, None] + rows[:, :, None] * Wc + cols[:, None, :])
    win = ref_flat[flat.reshape(-1)].reshape(-1, 3, 3)
    A = win[:, 0:2, 0:2]
    B = win[:, 0:2, 1:3]
    C = win[:, 1:3, 0:2]
    D = win[:, 1:3, 1:3]
    fx = (mvx & 7)[:, None, None]
    fy = (mvy & 7)[:, None, None]
    return ((8 - fx) * (8 - fy) * A + fx * (8 - fy) * B +
            (8 - fx) * fy * C + fx * fy * D + 32) >> 6


def wp_combine(p0, p1, use0, use1, w0, o0, w1, o1, d):
    """Unified 8.4.2.3 combine: default / explicit / implicit collapse
    into per-block (w, o, logWD); all [n4] broadcast over block dims."""
    nd = p0.ndim - 1
    bshape = (-1,) + (1,) * nd
    use0b = use0.reshape(bshape)
    use1b = use1.reshape(bshape)
    w0b = w0.reshape(bshape)
    o0b = o0.reshape(bshape)
    w1b = w1.reshape(bshape)
    o1b = o1.reshape(bshape)
    db = d.reshape(bshape)
    ps = jnp.where(use0b, p0, p1)
    ws = jnp.where(use0b, w0b, w1b)
    os_ = jnp.where(use0b, o0b, o1b)
    rnd = (jnp.int32(1) << db) >> 1
    single = _clip255(((ps * ws + rnd) >> db) + os_)
    bi = _clip255(((p0 * w0b + p1 * w1b + (jnp.int32(1) << db)) >> (db + 1))
                  + ((o0b + o1b + 1) >> 1))
    return jnp.where(use0b & use1b, bi, single)


def mc_frame(refs_y, refs_cb, refs_cr, rs0, rs1, mv0, mv1, wp, mb_w, mb_h):
    """Full-frame MC: returns (pred_y [n,16,16], pred_c [n,2,8,8]) int32
    in MB-tile layout.

    refs_*: [R,H,W]-shaped int32 (or uint8) reference stacks;
    rs0/rs1 [n4]: stack slot per 4x4 block per list (-1 = unused);
    mv0/mv1 [n4,2]; wp: dict of per-block combine params
    (wy0,oy0,wy1,oy1,dy, wcb0,... wcr1, dc) each [n4].

    rs1=None/mv1=None statically drops the list-1 window gathers (P
    pictures): the gather is the dominant device cost, so callers that
    know the picture type halve it this way."""
    H, W = mb_h * 16, mb_w * 16
    W4 = mb_w * 4
    n4 = W4 * mb_h * 4
    idx = jnp.arange(n4, dtype=jnp.int32)
    bx4 = idx % W4
    by4 = idx // W4
    one_list = rs1 is None
    use0 = rs0 >= 0
    use1 = (jnp.zeros_like(use0) if one_list else (rs1 >= 0))
    r0 = jnp.maximum(rs0, 0)
    r1 = None if one_list else jnp.maximum(rs1, 0)

    ry = refs_y.astype(jnp.int32).reshape(-1)
    p0y = mc_luma_blocks(ry, r0, mv0, bx4, by4, H, W)
    p1y = p0y if one_list else mc_luma_blocks(ry, r1, mv1, bx4, by4, H, W)
    py = wp_combine(p0y, p1y, use0, use1, wp["wy0"], wp["oy0"],
                    wp["wy1"], wp["oy1"], wp["dy"])

    Hc, Wc = H // 2, W // 2
    rcb = refs_cb.astype(jnp.int32).reshape(-1)
    rcr = refs_cr.astype(jnp.int32).reshape(-1)
    p0cb = mc_chroma_blocks(rcb, r0, mv0, bx4, by4, Hc, Wc)
    p1cb = (p0cb if one_list
            else mc_chroma_blocks(rcb, r1, mv1, bx4, by4, Hc, Wc))
    p0cr = mc_chroma_blocks(rcr, r0, mv0, bx4, by4, Hc, Wc)
    p1cr = (p0cr if one_list
            else mc_chroma_blocks(rcr, r1, mv1, bx4, by4, Hc, Wc))
    pcb = wp_combine(p0cb, p1cb, use0, use1, wp["wcb0"], wp["ocb0"],
                     wp["wcb1"], wp["ocb1"], wp["dc"])
    pcr = wp_combine(p0cr, p1cr, use0, use1, wp["wcr0"], wp["ocr0"],
                     wp["wcr1"], wp["ocr1"], wp["dc"])

    n = mb_w * mb_h
    pred_y = (py.reshape(mb_h, 4, mb_w, 4, 4, 4)
              .transpose(0, 2, 1, 4, 3, 5).reshape(n, 16, 16))
    pc = jnp.stack([pcb, pcr], axis=1)  # [n4,2,2,2]
    pred_c = (pc.reshape(mb_h, 4, mb_w, 4, 2, 2, 2)
              .transpose(0, 2, 4, 1, 5, 3, 6).reshape(n, 2, 8, 8))
    return pred_y, pred_c


def resolve_wp_blocks_jax(ri0, ri1, wp_mode, expl, denom_y, denom_c, imp,
                          n_ref1):
    """Device-side (traceable) port of resolve_wp_blocks.

    wp_mode is STATIC (one compiled variant per mode); expl [2,nmax,6]
    and imp [ncap,2] may be zero-padded; denom_y/denom_c/n_ref1 are
    traced int32 scalars (stream-dependent, no recompiles)."""
    import jax.numpy as jnp
    n4 = ri0.shape[0]
    z = jnp.zeros(n4, jnp.int32)
    one = jnp.ones(n4, jnp.int32)
    out = {"wy0": one, "oy0": z, "wy1": one, "oy1": z, "dy": z,
           "wcb0": one, "ocb0": z, "wcb1": one, "ocb1": z,
           "wcr0": one, "ocr0": z, "wcr1": one, "ocr1": z, "dc": z}
    if wp_mode == 1:
        i0 = jnp.clip(ri0, 0, expl.shape[1] - 1)
        i1 = jnp.clip(ri1, 0, expl.shape[1] - 1)
        e0 = expl[0, i0].astype(jnp.int32)
        e1 = expl[1, i1].astype(jnp.int32)
        dyv = jnp.full(n4, denom_y, jnp.int32)
        dcv = jnp.full(n4, denom_c, jnp.int32)
        out.update(
            wy0=e0[:, 0], oy0=e0[:, 1], wy1=e1[:, 0], oy1=e1[:, 1],
            dy=dyv,
            wcb0=e0[:, 2], ocb0=e0[:, 3], wcb1=e1[:, 2], ocb1=e1[:, 3],
            wcr0=e0[:, 4], ocr0=e0[:, 5], wcr1=e1[:, 4], ocr1=e1[:, 5],
            dc=dcv)
    elif wp_mode == 2:
        bi = (ri0 >= 0) & (ri1 >= 0)
        pair = (jnp.clip(ri0, 0, None) * n_ref1 + jnp.clip(ri1, 0, None))
        pair = jnp.clip(pair, 0, imp.shape[0] - 1)
        w0 = jnp.where(bi, imp[pair, 0], 1).astype(jnp.int32)
        w1 = jnp.where(bi, imp[pair, 1], 1).astype(jnp.int32)
        d = jnp.where(bi, 5, 0).astype(jnp.int32)
        out.update(wy0=w0, wy1=w1, dy=d, wcb0=w0, wcb1=w1,
                   wcr0=w0, wcr1=w1, dc=d)
    return out


def resolve_wp_blocks(ri0, ri1, wp_mode, expl, denom_y, denom_c, imp,
                      n_ref1):
    """Host-side per-block WP parameter resolution (numpy).

    ri0/ri1 [n4] list ref indices (-1 unused); wp_mode 0/1/2; expl
    [2, nmax, 6] (wy,oy,wcb,ocb,wcr,ocr) for explicit mode; imp
    [n_ref0*n_ref1, 2] implicit bi weights.  Returns the dict mc_frame
    wants, all int32 [n4]."""
    n4 = ri0.shape[0]
    z = np.zeros(n4, np.int32)
    one = np.ones(n4, np.int32)
    out = {"wy0": one.copy(), "oy0": z.copy(), "wy1": one.copy(),
           "oy1": z.copy(), "dy": z.copy(),
           "wcb0": one.copy(), "ocb0": z.copy(), "wcb1": one.copy(),
           "ocb1": z.copy(), "wcr0": one.copy(), "ocr0": z.copy(),
           "wcr1": one.copy(), "ocr1": z.copy(), "dc": z.copy()}
    if wp_mode == 1:
        i0 = np.clip(ri0, 0, expl.shape[1] - 1)
        i1 = np.clip(ri1, 0, expl.shape[1] - 1)
        e0 = expl[0, i0]
        e1 = expl[1, i1]
        out.update(
            wy0=e0[:, 0], oy0=e0[:, 1], wy1=e1[:, 0], oy1=e1[:, 1],
            dy=np.full(n4, denom_y, np.int32),
            wcb0=e0[:, 2], ocb0=e0[:, 3], wcb1=e1[:, 2], ocb1=e1[:, 3],
            wcr0=e0[:, 4], ocr0=e0[:, 5], wcr1=e1[:, 4], ocr1=e1[:, 5],
            dc=np.full(n4, denom_c, np.int32))
    elif wp_mode == 2:
        bi = (ri0 >= 0) & (ri1 >= 0)
        pair = (np.clip(ri0, 0, None) * n_ref1 +
                np.clip(ri1, 0, None)).astype(np.int64)
        pair = np.clip(pair, 0, imp.shape[0] - 1)
        w0 = np.where(bi, imp[pair, 0], 1).astype(np.int32)
        w1 = np.where(bi, imp[pair, 1], 1).astype(np.int32)
        d = np.where(bi, 5, 0).astype(np.int32)
        out.update(wy0=w0, wy1=w1, dy=d, wcb0=w0, wcb1=w1,
                   wcr0=w0, wcr1=w1, dc=d)
    return {k: np.ascontiguousarray(v, np.int32) for k, v in out.items()}
