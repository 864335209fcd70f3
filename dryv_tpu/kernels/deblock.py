"""Device-side in-loop deblocking (spec 8.7) as a wavefront tile scan.

The filter's macroblock raster-order semantics have exactly the intra
wavefront's dependency shape: filtering MB (x,y) reads/writes pixels of
(x-1,y) (vertical edge 0) and (x,y-1) (horizontal edge 0), and its top
edge additionally observes the above MB's corner columns already filtered
by (x+1,y-1)'s vertical edge 0 — i.e. deps {left, above, above-right},
the same anti-diagonals d = x + 2y as intra prediction.  (The upstream
reference has no deblocking at all — README.md:14 unchecked.)

Design: a second lane-aligned `lax.scan` over the recon scan's tile
outputs (same diagonal layout, so no re-gather).  Scan state carries the
two most recent diagonals' tiles (P1 = d-1, P2 = d-2):

  step d: filter MB tiles of diagonal d
    - V edges use left-neighbor cols 12..15 read from P1 (lane shift),
      writing the filtered cols back into P1 (the left MB's tile is not
      final until its right neighbor's V0 ran — this write)
    - H edges use above rows 12..15 from P2 (which already include the
      above-right V0 fixup applied during step d-1), writing back into P2
    - after the writeback, every diagonal d-2 tile is final: emit P2

Boundary strengths, alpha/beta thresholds, and tC0 depend only on syntax
(MB kinds, QPs, slice control), never on pixels, so they are precomputed
host-side in one vectorized pass and streamed to the scan as per-edge
arrays; bs == 0 encodes "edge not filtered" (unavailable / disabled /
cross-slice with disable_idc == 2 / 8x8-transform interior).

All arithmetic int32; bit-exact vs refimpl/deblock.py and libavcodec.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..refimpl.deblock import ALPHA, BETA, TC0
from ..refimpl.transform import QPC_TAB
from ..coeffs import KIND_I8, KIND_PCM
from .wavefront import diag_schedule, diag_shifts, _shift_lanes


# ---------------------------------------------------------------------------
# host precompute: per-MB edge parameters from syntax
# ---------------------------------------------------------------------------

def _qpc_vec(qp, off):
    qpi = np.clip(qp + off, 0, 51)
    return np.where(qpi < 30, qpi, QPC_TAB[np.clip(qpi - 30, 0, 21)])


PRE_KEYS = ["bsv", "tc0v", "av", "bv", "bsh", "tc0h", "ah", "bh",
            "bscv", "tc0cv", "acv", "bcv", "bsch", "tc0ch", "ach", "bch"]

# device kind numbering: intra kinds (coeffs.py + native extension)
_INTRA_KINDS = (0, 1, 2, 3, 11)  # I4, I8, I16, PCM, SI


def _pair_bs(intra_p, intra_q, mb_edge, nz_p, nz_q, mv0p, mv1p, mv0q, mv1q,
             rk0p, rk1p, rk0q, rk1q):
    """Vectorized 8.7.2.1 block-pair boundary strength (frames).

    All args broadcastable grids; mv* [..., 2]; rk* (-1 = list unused).
    Mirrors refimpl/deblock.py:_PicInfo.bs including the B-slice
    two-vector pairing rules."""
    def far(a, b):
        return (np.abs(a - b) >= 4).any(axis=-1)

    np_cnt = (rk0p >= 0).astype(np.int64) + (rk1p >= 0)
    nq_cnt = (rk0q >= 0).astype(np.int64) + (rk1q >= 0)
    # multiset of used keys: (lo, hi) with -1 sorting first
    lo_p = np.minimum(rk0p, rk1p)
    hi_p = np.maximum(rk0p, rk1p)
    lo_q = np.minimum(rk0q, rk1q)
    hi_q = np.maximum(rk0q, rk1q)
    keys_differ = (np_cnt != nq_cnt) | (lo_p != lo_q) | (hi_p != hi_q)

    # single-vector compare (the used list may differ between p and q)
    mvp1 = np.where((rk0p >= 0)[..., None], mv0p, mv1p)
    mvq1 = np.where((rk0q >= 0)[..., None], mv0q, mv1q)
    far1 = far(mvp1, mvq1)

    # two vectors, distinct pictures: pair by picture key
    aligned = rk0p == rk0q
    fa = far(mv0p, mv0q) | far(mv1p, mv1q)
    fx = far(mv0p, mv1q) | far(mv1p, mv0q)
    far2_distinct = np.where(aligned, fa, fx)
    # two vectors, same picture twice: bS 1 only if BOTH pairings far
    far2_same = fa & fx
    same_pic = rk0p == rk1p

    mv_bs = np.where(
        np_cnt == 1, far1,
        np.where(same_pic, far2_same, far2_distinct)).astype(np.int64)
    bs = np.where(keys_differ, 1, mv_bs)
    bs = np.where(nz_p | nz_q, 2, bs)
    intra_bs = np.where(mb_edge, 4, 3)
    return np.where(intra_p | intra_q, intra_bs, bs)


def deblock_precompute(kind, qp_y, slice_id, ctl, mb_w, mb_h,
                       chroma_off0, chroma_off1, t8=None, nz4=None,
                       mv0=None, mv1=None, rk0=None, rk1=None):
    """Edge parameters for a 4:2:0 picture (intra and/or inter MBs).

    kind/qp_y/slice_id: [n] int arrays (device kind numbering, native
    inter kinds 4..10 allowed); ctl: [n_slices, 3] (disable_idc, offA,
    offB).  Inter inputs (raster 4x4-block grids, optional for all-intra
    pictures): t8 [n] transform-size flags, nz4 [H4,W4] bool, mv0/mv1
    [H4,W4,2], rk0/rk1 [H4,W4] reference-picture keys (-1 unused).

    Returns dict of numpy arrays (see PRE_KEYS), all [n, ...] int32:
      bsv/tc0v  [n,4,4]  luma vertical edges x 4-row groups
      av/bv     [n,4]    alpha/beta per luma vertical edge
      bsh/tc0h/ah/bh     horizontal mirrors (groups = 4-col groups)
      bscv/tc0cv [n,2,8] / [n,2,2,8]  chroma vertical edges x lines
      acv/bcv   [n,2,2]  per edge x plane
      bsch/...           horizontal mirrors
    """
    n = mb_w * mb_h
    H4, W4 = mb_h * 4, mb_w * 4
    kind = np.asarray(kind).reshape(mb_h, mb_w)
    intra_mb = np.isin(kind, _INTRA_KINDS)
    qpy = np.where(kind == KIND_PCM, 0,
                   np.asarray(qp_y).reshape(mb_h, mb_w)).astype(np.int64)
    sid = np.asarray(slice_id).reshape(mb_h, mb_w)
    ctl = np.asarray(ctl, np.int64).reshape(-1, 3)
    dis = ctl[sid, 0]
    offa = ctl[sid, 1]
    offb = ctl[sid, 2]
    if t8 is None:
        t8 = kind == KIND_I8
    else:
        t8 = np.asarray(t8).reshape(mb_h, mb_w) != 0
        t8 = t8 | (kind == KIND_I8)
    qpc = np.stack([_qpc_vec(qpy, chroma_off0), _qpc_vec(qpy, chroma_off1)])

    mx = np.arange(mb_w)[None, :] * np.ones((mb_h, 1), np.int64)
    my = np.arange(mb_h)[:, None] * np.ones((1, mb_w), np.int64)

    def left(a, fill=0):
        """Shift a [rows, cols, ...] grid right by one column."""
        out = np.full_like(a, fill)
        out[:, 1:, ...] = a[:, :-1, ...]
        return out

    def up(a, fill=0):
        out = np.full_like(a, fill)
        out[1:, :, ...] = a[:-1, :, ...]
        return out

    # ---- block-pair strength grids BSV/BSH over the 4x4 lattice --------
    intra4 = np.repeat(np.repeat(intra_mb, 4, 0), 4, 1)
    if nz4 is None:
        nz4 = np.zeros((H4, W4), bool)
    else:
        nz4 = np.asarray(nz4).reshape(H4, W4) != 0
    z2 = np.zeros((H4, W4, 2), np.int64)
    neg = np.full((H4, W4), -1, np.int64)
    mv0 = z2 if mv0 is None else np.asarray(mv0, np.int64).reshape(H4, W4, 2)
    mv1 = z2 if mv1 is None else np.asarray(mv1, np.int64).reshape(H4, W4, 2)
    rk0 = neg if rk0 is None else np.asarray(rk0, np.int64).reshape(H4, W4)
    rk1 = neg if rk1 is None else np.asarray(rk1, np.int64).reshape(H4, W4)

    mbe_v = (np.arange(W4) % 4 == 0)[None, :] * np.ones((H4, 1), bool)
    mbe_h = (np.arange(H4) % 4 == 0)[:, None] * np.ones((1, W4), bool)
    BSV = _pair_bs(left(intra4), intra4, mbe_v, left(nz4), nz4,
                   left(mv0), left(mv1), mv0, mv1,
                   left(rk0, -1), left(rk1, -1), rk0, rk1)
    BSH = _pair_bs(up(intra4), intra4, mbe_h, up(nz4), nz4,
                   up(mv0), up(mv1), mv0, mv1,
                   up(rk0, -1), up(rk1, -1), rk0, rk1)
    # [mb_h, mb_w, edge(4), group(4)]: BSV[my*4+g, mx*4+e]
    BSVg = BSV.reshape(mb_h, 4, mb_w, 4).transpose(0, 2, 3, 1)
    BSHg = BSH.reshape(mb_h, 4, mb_w, 4).transpose(0, 2, 1, 3)

    on_self = dis != 1
    # MB-boundary edge enables (8.7: skip at picture edge; disable_idc 1
    # kills all edges of the MB's slice; 2 kills only cross-slice edges)
    on_v0 = on_self & (mx > 0) & ~((dis == 2) & (left(sid, -1) != sid))
    on_h0 = on_self & (my > 0) & ~((dis == 2) & (up(sid, -1) != sid))

    def idx_ab(qpav, off):
        return np.clip(qpav + off, 0, 51)

    def tc0_of(ia, bs):
        return TC0[ia, np.clip(bs, 1, 3) - 1]

    def luma_dir(on_e0, qp_nb, BSg):
        bs = np.zeros((mb_h, mb_w, 4, 4), np.int64)
        al = np.zeros((mb_h, mb_w, 4), np.int64)
        be = np.zeros((mb_h, mb_w, 4), np.int64)
        tc = np.zeros((mb_h, mb_w, 4, 4), np.int64)
        # edge 0 (MB boundary): thresholds from the QP average
        qpav = (qp_nb + qpy + 1) >> 1
        ia = idx_ab(qpav, offa)
        ib = idx_ab(qpav, offb)
        bs[..., 0, :] = BSg[..., 0, :] * on_e0[..., None]
        al[..., 0] = ALPHA[ia]
        be[..., 0] = BETA[ib]
        tc[..., 0, :] = tc0_of(ia[..., None], bs[..., 0, :])
        # internal edges; 8x8 transform keeps only edge 2
        ia_i = idx_ab(qpy, offa)
        ib_i = idx_ab(qpy, offb)
        for e in (1, 2, 3):
            on_e = on_self & ((e == 2) | ~t8)
            bs[..., e, :] = BSg[..., e, :] * on_e[..., None]
            al[..., e] = ALPHA[ia_i]
            be[..., e] = BETA[ib_i]
            tc[..., e, :] = tc0_of(ia_i[..., None], bs[..., e, :])
        return bs, tc, al, be

    bsv, tc0v, av, bv = luma_dir(on_v0, left(qpy), BSVg)
    bsh, tc0h, ah, bh = luma_dir(on_h0, up(qpy), BSHg)

    def chroma_dir(on_e0, qpc_nb, BSg):
        """Chroma (4:2:0): 2 edges x 8 lines; line cy maps to luma block
        group cy//2; chroma edges 0/4 map to luma edge cols {0, 2}."""
        bs = np.zeros((mb_h, mb_w, 2, 8), np.int64)
        al = np.zeros((mb_h, mb_w, 2, 2), np.int64)
        be = np.zeros((mb_h, mb_w, 2, 2), np.int64)
        tc = np.zeros((mb_h, mb_w, 2, 2, 8), np.int64)
        rep = np.repeat(np.arange(4), 2)  # line -> group
        bs[..., 0, :] = BSg[..., 0, :][..., rep] * on_e0[..., None]
        bs[..., 1, :] = BSg[..., 2, :][..., rep] * on_self[..., None]
        for pl in (0, 1):
            qpav = (qpc_nb[pl] + qpc[pl] + 1) >> 1
            ia = idx_ab(qpav, offa)
            ib = idx_ab(qpav, offb)
            al[..., 0, pl] = ALPHA[ia]
            be[..., 0, pl] = BETA[ib]
            tc[..., 0, pl, :] = tc0_of(ia[..., None], bs[..., 0, :])
            ia_i = idx_ab(qpc[pl], offa)
            ib_i = idx_ab(qpc[pl], offb)
            al[..., 1, pl] = ALPHA[ia_i]
            be[..., 1, pl] = BETA[ib_i]
            tc[..., 1, pl, :] = tc0_of(ia_i[..., None], bs[..., 1, :])
        return bs, tc, al, be

    qpc_l = np.stack([left(qpc[0]), left(qpc[1])])
    qpc_u = np.stack([up(qpc[0]), up(qpc[1])])
    bscv, tc0cv, acv, bcv = chroma_dir(on_v0, qpc_l, BSVg)
    bsch, tc0ch, ach, bch = chroma_dir(on_h0, qpc_u, BSHg)

    out = dict(bsv=bsv, tc0v=tc0v, av=av, bv=bv,
               bsh=bsh, tc0h=tc0h, ah=ah, bh=bh,
               bscv=bscv, tc0cv=tc0cv, acv=acv, bcv=bcv,
               bsch=bsch, tc0ch=tc0ch, ach=ach, bch=bch)
    return {k: v.reshape((n,) + v.shape[2:]).astype(np.int32)
            for k, v in out.items()}


# back-compat name (intra pictures)
deblock_precompute_intra = deblock_precompute


# ---------------------------------------------------------------------------
# device precompute: the all-intra specialization of deblock_precompute,
# in jax.numpy so it runs ON the device inside the jitted GOP pipeline: a
# handful of fused gathers over tensors the pipeline ships anyway
# (kind/qp) plus a [n]-sized slice-control vector, instead of a host
# precompute and its own host-to-device transfer.
# ---------------------------------------------------------------------------

def deblock_precompute_intra_jax(kind, qp_y, sid, dis, offa, offb,
                                 mb_w, mb_h, chroma_off0, chroma_off1):
    """All-intra edge parameters, traceable (device) version.

    kind/qp_y/sid/dis/offa/offb: [n] integer arrays (per-MB; dis/offa/offb
    are the MB's slice's deblock control, already gathered per MB so no
    dynamic slice table is needed on device).  Static: mb_w/mb_h/offsets.
    Returns the PRE_KEYS dict, int32, bit-identical to
    deblock_precompute(kind, ..., ctl) for all-intra pictures."""
    alpha_t = jnp.asarray(ALPHA, jnp.int32)
    beta_t = jnp.asarray(BETA, jnp.int32)
    tc0_t = jnp.asarray(TC0, jnp.int32)
    qpc_tab = jnp.asarray(QPC_TAB, jnp.int32)

    def qpc_vec(qp, off):
        qpi = jnp.clip(qp + off, 0, 51)
        return jnp.where(qpi < 30, qpi, qpc_tab[jnp.clip(qpi - 30, 0, 21)])

    kind = jnp.asarray(kind, jnp.int32).reshape(mb_h, mb_w)
    qpy = jnp.where(kind == KIND_PCM, 0,
                    jnp.asarray(qp_y, jnp.int32).reshape(mb_h, mb_w))
    sid = jnp.asarray(sid, jnp.int32).reshape(mb_h, mb_w)
    dis = jnp.asarray(dis, jnp.int32).reshape(mb_h, mb_w)
    offa = jnp.asarray(offa, jnp.int32).reshape(mb_h, mb_w)
    offb = jnp.asarray(offb, jnp.int32).reshape(mb_h, mb_w)
    t8 = kind == KIND_I8
    qpc = jnp.stack([qpc_vec(qpy, chroma_off0), qpc_vec(qpy, chroma_off1)])

    def left(a, fill=0):
        return jnp.pad(a[:, :-1], ((0, 0), (1, 0)), constant_values=fill)

    def up(a, fill=0):
        return jnp.pad(a[:-1, :], ((1, 0), (0, 0)), constant_values=fill)

    # all-intra: block-pair strength is 4 on MB edges, 3 internal
    on_self = dis != 1
    mx = jnp.arange(mb_w, dtype=jnp.int32)[None, :]
    my = jnp.arange(mb_h, dtype=jnp.int32)[:, None]
    on_v0 = on_self & (mx > 0) & ~((dis == 2) & (left(sid, -1) != sid))
    on_h0 = on_self & (my > 0) & ~((dis == 2) & (up(sid, -1) != sid))

    def idx_ab(qpav, off):
        return jnp.clip(qpav + off, 0, 51)

    def tc0_of(ia, bs):
        return tc0_t[ia, jnp.clip(bs, 1, 3) - 1]

    def luma_dir(on_e0, qp_nb):
        qpav = (qp_nb + qpy + 1) >> 1
        ia0 = idx_ab(qpav, offa)
        ib0 = idx_ab(qpav, offb)
        ia_i = idx_ab(qpy, offa)
        ib_i = idx_ab(qpy, offb)
        on0 = on_e0.astype(jnp.int32)
        oni = on_self.astype(jnp.int32)
        # edges: 0 = MB boundary (bS 4), 1..3 internal (bS 3; 8x8 keeps 2)
        bs_e = jnp.stack([
            4 * on0,
            3 * oni * (~t8).astype(jnp.int32),
            3 * oni,
            3 * oni * (~t8).astype(jnp.int32)], axis=-1)       # [h,w,4]
        bs = jnp.broadcast_to(bs_e[..., None], bs_e.shape + (4,))
        al = jnp.stack([alpha_t[ia0]] + [alpha_t[ia_i]] * 3, axis=-1)
        be = jnp.stack([beta_t[ib0]] + [beta_t[ib_i]] * 3, axis=-1)
        ia = jnp.stack([ia0] + [ia_i] * 3, axis=-1)            # [h,w,4]
        tc = tc0_of(ia[..., None], bs)
        return bs, tc, al, be

    bsv, tc0v, av, bv = luma_dir(on_v0, left(qpy))
    bsh, tc0h, ah, bh = luma_dir(on_h0, up(qpy))

    def chroma_dir(on_e0, qpc_nb):
        on0 = on_e0.astype(jnp.int32)
        oni = on_self.astype(jnp.int32)
        bs = jnp.stack([
            jnp.broadcast_to((4 * on0)[..., None], on0.shape + (8,)),
            jnp.broadcast_to((3 * oni)[..., None], oni.shape + (8,))],
            axis=-2)                                           # [h,w,2,8]
        al = []
        be = []
        tc = []
        for pl in (0, 1):
            qpav = (qpc_nb[pl] + qpc[pl] + 1) >> 1
            ia0 = idx_ab(qpav, offa)
            ib0 = idx_ab(qpav, offb)
            ia_i = idx_ab(qpc[pl], offa)
            ib_i = idx_ab(qpc[pl], offb)
            al.append(jnp.stack([alpha_t[ia0], alpha_t[ia_i]], axis=-1))
            be.append(jnp.stack([beta_t[ib0], beta_t[ib_i]], axis=-1))
            ia = jnp.stack([ia0, ia_i], axis=-1)               # [h,w,2]
            tc.append(tc0_of(ia[..., None], bs))
        al = jnp.stack(al, axis=-1)                            # [h,w,2,2]
        be = jnp.stack(be, axis=-1)
        tc = jnp.stack(tc, axis=-2)                   # [h,w,edge,pl,line]
        return bs, tc, al, be

    qpc_l = jnp.stack([left(qpc[0]), left(qpc[1])])
    qpc_u = jnp.stack([up(qpc[0]), up(qpc[1])])
    bscv, tc0cv, acv, bcv = chroma_dir(on_v0, qpc_l)
    bsch, tc0ch, ach, bch = chroma_dir(on_h0, qpc_u)

    n = mb_w * mb_h
    out = dict(bsv=bsv, tc0v=tc0v, av=av, bv=bv,
               bsh=bsh, tc0h=tc0h, ah=ah, bh=bh,
               bscv=bscv, tc0cv=tc0cv, acv=acv, bcv=bcv,
               bsch=bsch, tc0ch=tc0ch, ach=ach, bch=bch)
    return {k: v.reshape((n,) + v.shape[2:]).astype(jnp.int32)
            for k, v in out.items()}


def _pair_bs_jax(intra_p, intra_q, mb_edge, nz_p, nz_q, mv0p, mv1p, mv0q,
                 mv1q, rk0p, rk1p, rk0q, rk1q):
    """jnp port of _pair_bs (spec 8.7.2.1 block-pair boundary strength),
    for the on-device inter edge-parameter precompute."""
    def far(a, b):
        return (jnp.abs(a - b) >= 4).any(axis=-1)

    np_cnt = (rk0p >= 0).astype(jnp.int32) + (rk1p >= 0)
    nq_cnt = (rk0q >= 0).astype(jnp.int32) + (rk1q >= 0)
    lo_p = jnp.minimum(rk0p, rk1p)
    hi_p = jnp.maximum(rk0p, rk1p)
    lo_q = jnp.minimum(rk0q, rk1q)
    hi_q = jnp.maximum(rk0q, rk1q)
    keys_differ = (np_cnt != nq_cnt) | (lo_p != lo_q) | (hi_p != hi_q)

    mvp1 = jnp.where((rk0p >= 0)[..., None], mv0p, mv1p)
    mvq1 = jnp.where((rk0q >= 0)[..., None], mv0q, mv1q)
    far1 = far(mvp1, mvq1)

    aligned = rk0p == rk0q
    fa = far(mv0p, mv0q) | far(mv1p, mv1q)
    fx = far(mv0p, mv1q) | far(mv1p, mv0q)
    far2_distinct = jnp.where(aligned, fa, fx)
    far2_same = fa & fx
    same_pic = rk0p == rk1p

    mv_bs = jnp.where(np_cnt == 1, far1,
                      jnp.where(same_pic, far2_same,
                                far2_distinct)).astype(jnp.int32)
    bs = jnp.where(keys_differ, 1, mv_bs)
    bs = jnp.where(nz_p | nz_q, 2, bs)
    intra_bs = jnp.where(mb_edge, 4, 3)
    return jnp.where(intra_p | intra_q, intra_bs, bs)


def deblock_precompute_jax(kind, qp_y, sid, dis, offa, offb, mb_w, mb_h,
                           chroma_off0, chroma_off1, t8, nz4,
                           mv0, mv1, rk0, rk1):
    """General (intra + inter) edge parameters, traceable device version.

    jnp port of deblock_precompute: kind/qp_y/sid/dis/offa/offb/t8 [n]
    per-MB int arrays; nz4 [H4,W4] bool, mv0/mv1 [H4,W4,2] int32,
    rk0/rk1 [H4,W4] reference keys or stack slots (-1 = list unused;
    only equality matters, so per-picture slots work).  Returns the
    PRE_KEYS dict, int32, bit-identical to the host deblock_precompute."""
    alpha_t = jnp.asarray(ALPHA, jnp.int32)
    beta_t = jnp.asarray(BETA, jnp.int32)
    tc0_t = jnp.asarray(TC0, jnp.int32)
    qpc_tab = jnp.asarray(QPC_TAB, jnp.int32)

    def qpc_vec(qp, off):
        qpi = jnp.clip(qp + off, 0, 51)
        return jnp.where(qpi < 30, qpi, qpc_tab[jnp.clip(qpi - 30, 0, 21)])

    H4, W4 = mb_h * 4, mb_w * 4
    kind = jnp.asarray(kind, jnp.int32).reshape(mb_h, mb_w)
    intra_mb = (kind <= 3) | (kind == 11)    # native numbering + SI
    qpy = jnp.where(kind == KIND_PCM, 0,
                    jnp.asarray(qp_y, jnp.int32).reshape(mb_h, mb_w))
    sid = jnp.asarray(sid, jnp.int32).reshape(mb_h, mb_w)
    dis = jnp.asarray(dis, jnp.int32).reshape(mb_h, mb_w)
    offa = jnp.asarray(offa, jnp.int32).reshape(mb_h, mb_w)
    offb = jnp.asarray(offb, jnp.int32).reshape(mb_h, mb_w)
    t8 = (jnp.asarray(t8, jnp.int32).reshape(mb_h, mb_w) != 0) \
        | (kind == KIND_I8)
    qpc = jnp.stack([qpc_vec(qpy, chroma_off0), qpc_vec(qpy, chroma_off1)])

    def left(a, fill=0):
        pad = [(0, 0)] * a.ndim
        pad[1] = (1, 0)
        return jnp.pad(a[:, :-1], pad, constant_values=fill)

    def up(a, fill=0):
        pad = [(0, 0)] * a.ndim
        pad[0] = (1, 0)
        return jnp.pad(a[:-1], pad, constant_values=fill)

    intra4 = jnp.repeat(jnp.repeat(intra_mb, 4, 0), 4, 1)
    nz4 = jnp.asarray(nz4).reshape(H4, W4) != 0
    mv0 = jnp.asarray(mv0, jnp.int32).reshape(H4, W4, 2)
    mv1 = jnp.asarray(mv1, jnp.int32).reshape(H4, W4, 2)
    rk0 = jnp.asarray(rk0, jnp.int32).reshape(H4, W4)
    rk1 = jnp.asarray(rk1, jnp.int32).reshape(H4, W4)

    mbe_v = jnp.broadcast_to((jnp.arange(W4) % 4 == 0)[None, :], (H4, W4))
    mbe_h = jnp.broadcast_to((jnp.arange(H4) % 4 == 0)[:, None], (H4, W4))
    BSV = _pair_bs_jax(left(intra4), intra4, mbe_v, left(nz4), nz4,
                       left(mv0), left(mv1), mv0, mv1,
                       left(rk0, -1), left(rk1, -1), rk0, rk1)
    BSH = _pair_bs_jax(up(intra4), intra4, mbe_h, up(nz4), nz4,
                       up(mv0), up(mv1), mv0, mv1,
                       up(rk0, -1), up(rk1, -1), rk0, rk1)
    BSVg = BSV.reshape(mb_h, 4, mb_w, 4).transpose(0, 2, 3, 1)
    BSHg = BSH.reshape(mb_h, 4, mb_w, 4).transpose(0, 2, 1, 3)

    on_self = dis != 1
    mx = jnp.arange(mb_w, dtype=jnp.int32)[None, :]
    my = jnp.arange(mb_h, dtype=jnp.int32)[:, None]
    on_v0 = on_self & (mx > 0) & ~((dis == 2) & (left(sid, -1) != sid))
    on_h0 = on_self & (my > 0) & ~((dis == 2) & (up(sid, -1) != sid))

    def idx_ab(qpav, off):
        return jnp.clip(qpav + off, 0, 51)

    def tc0_of(ia, bs):
        return tc0_t[ia, jnp.clip(bs, 1, 3) - 1]

    def luma_dir(on_e0, qp_nb, BSg):
        qpav = (qp_nb + qpy + 1) >> 1
        ia0 = idx_ab(qpav, offa)
        ib0 = idx_ab(qpav, offb)
        ia_i = idx_ab(qpy, offa)
        ib_i = idx_ab(qpy, offb)
        on0 = on_e0.astype(jnp.int32)
        oni = on_self.astype(jnp.int32)
        onk = oni * (~t8).astype(jnp.int32)
        # per-edge enables: edge 0 = MB boundary; 8x8 keeps only edge 2
        ons = jnp.stack([on0, onk, oni, onk], axis=-1)        # [h,w,4]
        bs = BSg * ons[..., None]
        al = jnp.stack([alpha_t[ia0]] + [alpha_t[ia_i]] * 3, axis=-1)
        be = jnp.stack([beta_t[ib0]] + [beta_t[ib_i]] * 3, axis=-1)
        ia = jnp.stack([ia0] + [ia_i] * 3, axis=-1)           # [h,w,4]
        tc = tc0_of(ia[..., None], bs)
        return bs, tc, al, be

    bsv, tc0v, av, bv = luma_dir(on_v0, left(qpy), BSVg)
    bsh, tc0h, ah, bh = luma_dir(on_h0, up(qpy), BSHg)

    rep = jnp.repeat(jnp.arange(4), 2)

    def chroma_dir(on_e0, qpc_nb, BSg):
        on0 = on_e0.astype(jnp.int32)
        oni = on_self.astype(jnp.int32)
        bs = jnp.stack([BSg[..., 0, :][..., rep] * on0[..., None],
                        BSg[..., 2, :][..., rep] * oni[..., None]],
                       axis=-2)                               # [h,w,2,8]
        al = []
        be = []
        tc = []
        for pl in (0, 1):
            qpav = (qpc_nb[pl] + qpc[pl] + 1) >> 1
            ia0 = idx_ab(qpav, offa)
            ib0 = idx_ab(qpav, offb)
            ia_i = idx_ab(qpc[pl], offa)
            ib_i = idx_ab(qpc[pl], offb)
            al.append(jnp.stack([alpha_t[ia0], alpha_t[ia_i]], axis=-1))
            be.append(jnp.stack([beta_t[ib0], beta_t[ib_i]], axis=-1))
            ia = jnp.stack([ia0, ia_i], axis=-1)              # [h,w,2]
            tc.append(tc0_of(ia[..., None], bs))
        al = jnp.stack(al, axis=-1)
        be = jnp.stack(be, axis=-1)
        tc = jnp.stack(tc, axis=-2)                  # [h,w,edge,pl,line]
        return bs, tc, al, be

    qpc_l = jnp.stack([left(qpc[0]), left(qpc[1])])
    qpc_u = jnp.stack([up(qpc[0]), up(qpc[1])])
    bscv, tc0cv, acv, bcv = chroma_dir(on_v0, qpc_l, BSVg)
    bsch, tc0ch, ach, bch = chroma_dir(on_h0, qpc_u, BSHg)

    n = mb_w * mb_h
    out = dict(bsv=bsv, tc0v=tc0v, av=av, bv=bv,
               bsh=bsh, tc0h=tc0h, ah=ah, bh=bh,
               bscv=bscv, tc0cv=tc0cv, acv=acv, bcv=bcv,
               bsch=bsch, tc0ch=tc0ch, ach=ach, bch=bch)
    return {k: v.reshape((n,) + v.shape[2:]).astype(jnp.int32)
            for k, v in out.items()}


# ---------------------------------------------------------------------------
# device filters (exact int32 mirrors of refimpl/deblock.py)
# ---------------------------------------------------------------------------

def _filt_luma_taps(p3, p2, p1, p0, q0, q1, q2, q3, bs, alpha, beta, tc0):
    """Luma edge filter on individual sample taps (all [..., L] int32;
    p0/q0 nearest the edge).  Returns the six modified taps
    (p2n, p1n, p0n, q0n, q1n, q2n); p3/q3 never change."""
    filt = ((bs > 0) & (jnp.abs(p0 - q0) < alpha)
            & (jnp.abs(p1 - p0) < beta) & (jnp.abs(q1 - q0) < beta))
    ap = jnp.abs(p2 - p0)
    aq = jnp.abs(q2 - q0)
    tc = tc0 + (ap < beta).astype(jnp.int32) + (aq < beta).astype(jnp.int32)
    delta = jnp.clip(((q0 - p0) * 4 + (p1 - q1) + 4) >> 3, -tc, tc)
    p0w = jnp.clip(p0 + delta, 0, 255)
    q0w = jnp.clip(q0 - delta, 0, 255)
    p1w = p1 + jnp.clip((p2 + ((p0 + q0 + 1) >> 1) - 2 * p1) >> 1, -tc0, tc0)
    q1w = q1 + jnp.clip((q2 + ((p0 + q0 + 1) >> 1) - 2 * q1) >> 1, -tc0, tc0)
    strong = jnp.abs(p0 - q0) < (alpha >> 2) + 2
    sp = (ap < beta) & strong
    sq = (aq < beta) & strong
    p0s = jnp.where(sp, (p2 + 2 * p1 + 2 * p0 + 2 * q0 + q1 + 4) >> 3,
                    (2 * p1 + p0 + q1 + 2) >> 2)
    p1s = jnp.where(sp, (p2 + p1 + p0 + q0 + 2) >> 2, p1)
    p2s = jnp.where(sp, (2 * p3 + 3 * p2 + p1 + p0 + q0 + 4) >> 3, p2)
    q0s = jnp.where(sq, (q2 + 2 * q1 + 2 * q0 + 2 * p0 + p1 + 4) >> 3,
                    (2 * q1 + q0 + p1 + 2) >> 2)
    q1s = jnp.where(sq, (q2 + q1 + q0 + p0 + 2) >> 2, q1)
    q2s = jnp.where(sq, (2 * q3 + 3 * q2 + q1 + q0 + p0 + 4) >> 3, q2)
    b4 = bs == 4
    return (jnp.where(filt & b4, p2s, p2),
            jnp.where(filt, jnp.where(b4, p1s,
                      jnp.where(ap < beta, p1w, p1)), p1),
            jnp.where(filt, jnp.where(b4, p0s, p0w), p0),
            jnp.where(filt, jnp.where(b4, q0s, q0w), q0),
            jnp.where(filt, jnp.where(b4, q1s,
                      jnp.where(aq < beta, q1w, q1)), q1),
            jnp.where(filt & b4, q2s, q2))


def _filt_chroma_taps(p1, p0, q0, q1, bs, alpha, beta, tc0):
    """Chroma edge filter; only p0/q0 change.  Returns (p0n, q0n)."""
    filt = ((bs > 0) & (jnp.abs(p0 - q0) < alpha)
            & (jnp.abs(p1 - p0) < beta) & (jnp.abs(q1 - q0) < beta))
    tc = tc0 + 1
    delta = jnp.clip(((q0 - p0) * 4 + (p1 - q1) + 4) >> 3, -tc, tc)
    p0w = jnp.clip(p0 + delta, 0, 255)
    q0w = jnp.clip(q0 - delta, 0, 255)
    p0s = (2 * p1 + p0 + q1 + 2) >> 2
    q0s = (2 * q1 + q0 + p1 + 2) >> 2
    b4 = bs == 4
    return (jnp.where(filt, jnp.where(b4, p0s, p0w), p0),
            jnp.where(filt, jnp.where(b4, q0s, q0w), q0))


def _rep4(a):
    """[..., G] -> [..., 4G]: each group value covers 4 sample lines."""
    return jnp.repeat(a, 4, axis=-1)


# ---------------------------------------------------------------------------
# the deblock lane step
# ---------------------------------------------------------------------------

def lane_deblock_step(x, K, state):
    """One diagonal of the deblock wavefront.  Emits the finalized tiles
    of diagonal d-2 (uint8)."""
    P1, P2 = state["P1"], state["P2"]
    Pc1, Pc2 = state["Pc1"], state["Pc2"]
    has_l = x["has_l"]
    has_a = x["has_a"]

    T = x["ty"].astype(jnp.int32)          # [K,16,16]
    Tc = x["tc"].astype(jnp.int32)         # [K,2,8,8]
    Lf = _shift_lanes(P1, x["s_lf"], K)    # left tiles (diag d-1)
    Af = _shift_lanes(P2, x["s_ab"], K)    # above tiles (diag d-2)
    Lcf = _shift_lanes(Pc1, x["s_lf"], K)
    Acf = _shift_lanes(Pc2, x["s_ab"], K)

    # ---- luma vertical edges on the widened window ----------------------
    # per-tap column slices: no reverses/transposes (Mosaic-friendly HLO)
    W = jnp.concatenate([Lf[:, :, 12:16], T], axis=2)   # [K,16,20]
    for e in range(4):
        c = 4 + 4 * e
        taps = _filt_luma_taps(
            W[:, :, c - 4], W[:, :, c - 3], W[:, :, c - 2], W[:, :, c - 1],
            W[:, :, c], W[:, :, c + 1], W[:, :, c + 2], W[:, :, c + 3],
            _rep4(x["bsv"][:, e, :]), x["av"][:, e:e + 1],
            x["bv"][:, e:e + 1], _rep4(x["tc0v"][:, e, :]))
        for off, v in zip((c - 3, c - 2, c - 1, c, c + 1, c + 2), taps):
            W = W.at[:, :, off].set(v)

    # ---- luma horizontal edges ------------------------------------------
    Hw = jnp.concatenate([Af[:, 12:16, :], W[:, :, 4:20]], axis=1)  # [K,20,16]
    for e in range(4):
        r = 4 + 4 * e
        taps = _filt_luma_taps(
            Hw[:, r - 4, :], Hw[:, r - 3, :], Hw[:, r - 2, :],
            Hw[:, r - 1, :], Hw[:, r, :], Hw[:, r + 1, :], Hw[:, r + 2, :],
            Hw[:, r + 3, :],
            _rep4(x["bsh"][:, e, :]), x["ah"][:, e:e + 1],
            x["bh"][:, e:e + 1], _rep4(x["tc0h"][:, e, :]))
        for off, v in zip((r - 3, r - 2, r - 1, r, r + 1, r + 2), taps):
            Hw = Hw.at[:, off, :].set(v)

    own = Hw[:, 4:20, :]
    upd_L = Lf.at[:, :, 12:16].set(W[:, :, 0:4])
    upd_A = Af.at[:, 12:16, :].set(Hw[:, 0:4, :])

    # ---- chroma (4:2:0), both planes vectorized on axis 1 ---------------
    Wc = jnp.concatenate([Lcf[:, :, :, 6:8], Tc], axis=3)  # [K,2,8,10]
    for e in range(2):
        c = 2 + 4 * e
        p0n, q0n = _filt_chroma_taps(
            Wc[:, :, :, c - 2], Wc[:, :, :, c - 1],
            Wc[:, :, :, c], Wc[:, :, :, c + 1],
            x["bscv"][:, None, e, :],
            x["acv"][:, e, :][:, :, None], x["bcv"][:, e, :][:, :, None],
            x["tc0cv"][:, e])
        Wc = Wc.at[:, :, :, c - 1].set(p0n)
        Wc = Wc.at[:, :, :, c].set(q0n)

    Hc = jnp.concatenate([Acf[:, :, 6:8, :], Wc[:, :, :, 2:10]], axis=2)
    for e in range(2):
        r = 2 + 4 * e
        p0n, q0n = _filt_chroma_taps(
            Hc[:, :, r - 2, :], Hc[:, :, r - 1, :],
            Hc[:, :, r, :], Hc[:, :, r + 1, :],
            x["bsch"][:, None, e, :],
            x["ach"][:, e, :][:, :, None], x["bch"][:, e, :][:, :, None],
            x["tc0ch"][:, e])
        Hc = Hc.at[:, :, r - 1, :].set(p0n)
        Hc = Hc.at[:, :, r, :].set(q0n)

    ownc = Hc[:, :, 2:10, :]
    upd_Lc = Lcf.at[:, :, :, 6:8].set(Wc[:, :, :, 0:2])
    upd_Ac = Acf.at[:, :, 6:8, :].set(Hc[:, :, 0:2, :])

    # ---- writebacks (inverse lane shifts, masked) ------------------------
    def back(upd, base, shift, mask):
        m = _shift_lanes(mask, -shift, K)
        u = _shift_lanes(upd, -shift, K)
        return jnp.where(m.reshape((K,) + (1,) * (base.ndim - 1)), u, base)

    P1n = back(upd_L, P1, x["s_lf"], has_l)
    P2f = back(upd_A, P2, x["s_ab"], has_a)
    Pc1n = back(upd_Lc, Pc1, x["s_lf"], has_l)
    Pc2f = back(upd_Ac, Pc2, x["s_ab"], has_a)

    new_state = {"P1": own, "P2": P1n, "Pc1": ownc, "Pc2": Pc1n}
    return new_state, P2f.astype(jnp.uint8), Pc2f.astype(jnp.uint8)


def make_deblock_tiles_fn(mb_w: int, mb_h: int):
    """Returns fn(tiles_y, tiles_c, pre) filtering recon tile outputs.

    tiles_y [n_diag,K,16,16] uint8, tiles_c [n_diag,K,2,8,8] uint8 in the
    wavefront's diagonal layout; pre: dict of [n, ...] edge-parameter
    arrays (deblock_precompute_intra).  Returns filtered tiles in the same
    layout."""
    sched_np, _, _ = diag_schedule(mb_w, mb_h)
    s_ab, _, s_lf, _ = diag_shifts(mb_w, mb_h)
    n_diag, K = sched_np.shape
    addrs_np = np.maximum(sched_np, 0)
    valid_np = sched_np >= 0
    mx_np = addrs_np % mb_w
    my_np = addrs_np // mb_w
    has_l_np = valid_np & (mx_np > 0)
    has_a_np = valid_np & (my_np > 0)

    def pad2(a):
        return jnp.pad(a, ((0, 2),) + ((0, 0),) * (a.ndim - 1))

    addrs = jnp.asarray(addrs_np)
    has_l = pad2(jnp.asarray(has_l_np))
    has_a = pad2(jnp.asarray(has_a_np))
    s_lf_j = pad2(jnp.asarray(s_lf))
    s_ab_j = pad2(jnp.asarray(s_ab))

    def run(tiles_y, tiles_c, pre):
        xs = {k: pad2(jnp.asarray(pre[k])[addrs]) for k in PRE_KEYS}
        xs["ty"] = pad2(tiles_y)
        xs["tc"] = pad2(tiles_c)
        xs["has_l"] = has_l
        xs["has_a"] = has_a
        xs["s_lf"] = s_lf_j
        xs["s_ab"] = s_ab_j

        z = tiles_y.astype(jnp.int32)[0, 0, 0, 0] * 0
        state = {
            "P1": jnp.zeros((K, 16, 16), jnp.int32) + z,
            "P2": jnp.zeros((K, 16, 16), jnp.int32) + z,
            "Pc1": jnp.zeros((K, 2, 8, 8), jnp.int32) + z,
            "Pc2": jnp.zeros((K, 2, 8, 8), jnp.int32) + z,
        }

        def step(st, x):
            st, ty, tc = lane_deblock_step(x, K, st)
            return st, (ty, tc)

        _, (ty, tc) = jax.lax.scan(step, state, xs)
        return ty[2:], tc[2:]

    return run
