"""Stage B: intra prediction + reconstruction as an anti-diagonal MB wavefront.

The intra feedback loop (prediction reads already-reconstructed neighbor
pixels, reference pred4x4.rs:62) forces sequential ordering; the exploitable
parallelism is the classic H.264 wavefront: MB (x, y) depends on
(x-1,y), (x,y-1), (x+1,y-1), (x-1,y-1), so all MBs with equal d = x + 2y
are independent.

State design ("frontier wavefront"): the scan carries only the
dependency frontier — the bottom pixel row of the newest (and previous)
completed MB per MB-column plus the right pixel column per MB-row (a few
KB), NOT the frame planes.  Each diagonal step gathers its lanes' aprons
from the frontier, reconstructs every MB of the diagonal in parallel
(branchless per-kind compute), updates the frontier with small scatters,
and emits the finished 16x16 tiles as scan outputs; the planes are
assembled afterwards with one parallel gather.  This keeps the sequential
loop free of full-plane scatter/gather traffic.

All arithmetic is exact int32: output is bit-identical to the scalar
refimpl path (and the libavcodec goldens).  The device paths run the same
schedule as one Pallas kernel (kernels/wavefront_kernel.py); the scan
here is its plain reference, and frontier_step drives the band-sharded
path (parallel/bands.py).
"""
from __future__ import annotations

from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np

from ..avc.neighbors import ZSCAN_4X4_POS, POS_TO_ZSCAN
from ..coeffs import KIND_I4, KIND_I8, KIND_I16, KIND_PCM
from . import intra_pred as ipk

# ---------------------------------------------------------------------------
# static schedules / tables
# ---------------------------------------------------------------------------


@lru_cache(maxsize=None)
def diag_shifts(mb_w: int, mb_h: int):
    """Lane-alignment shifts between consecutive diagonals.

    Lanes within a diagonal are ordered by ascending MB row; base(d) is the
    first row on diagonal d.  A lane's neighbors on earlier diagonals sit at
    uniform lane offsets determined by base() differences, so frontier state
    can be carried per-lane and read with shifted slices (no gather):
      above       (mx,   my-1) on d-2 at lane k + base(d)-base(d-2)-1
      above-right (mx+1, my-1) on d-1 at lane k + base(d)-base(d-1)-1
      left        (mx-1, my  ) on d-1 at lane k + base(d)-base(d-1)
      corner      (mx-1, my-1) on d-3 at lane k + base(d)-base(d-3)-1
    Returns (s_above [n_diag], s_ar [n_diag], s_left [n_diag],
    s_corner [n_diag]) int32."""
    n_diag = mb_w + 2 * (mb_h - 1)

    def base(d):
        if d < 0:
            return 0
        return max(0, -(-(d - mb_w + 1) // 2))

    s_ab = np.zeros(n_diag, np.int32)
    s_ar = np.zeros(n_diag, np.int32)
    s_lf = np.zeros(n_diag, np.int32)
    s_cn = np.zeros(n_diag, np.int32)
    for d in range(n_diag):
        s_ab[d] = base(d) - base(d - 2) - 1
        s_ar[d] = base(d) - base(d - 1) - 1
        s_lf[d] = base(d) - base(d - 1)
        s_cn[d] = base(d) - base(d - 3) - 1
    return s_ab, s_ar, s_lf, s_cn


@lru_cache(maxsize=None)
def diag_schedule(mb_w: int, mb_h: int):
    """Returns (sched [n_diag, K], d_of [n], k_of [n]): MB addresses per
    anti-diagonal (x + 2y = d, -1 padded) and the inverse mapping."""
    diags = {}
    for my in range(mb_h):
        for mx in range(mb_w):
            diags.setdefault(mx + 2 * my, []).append(my * mb_w + mx)
    n_diag = mb_w + 2 * (mb_h - 1)
    K = max(len(v) for v in diags.values())
    sched = np.full((n_diag, K), -1, dtype=np.int32)
    d_of = np.zeros(mb_w * mb_h, dtype=np.int32)
    k_of = np.zeros(mb_w * mb_h, dtype=np.int32)
    for d, addrs in diags.items():
        sched[d, :len(addrs)] = addrs
        for k, a in enumerate(addrs):
            d_of[a] = d
            k_of[a] = k
    return sched, d_of, k_of


# per-4x4-block availability source: 0=always True, 1=mb_a, 2=mb_b, 3=mb_c,
# 4=mb_d, 5=always False
def _blk4_avail_tables():
    a_src, b_src, c_src, d_src = [], [], [], []
    for blk in range(16):
        bx, by = ZSCAN_4X4_POS[blk]
        a_src.append(0 if bx > 0 else 1)
        b_src.append(0 if by > 0 else 2)
        if bx > 0 and by > 0:
            d_src.append(0)
        elif bx == 0 and by > 0:
            d_src.append(1)
        elif bx > 0 and by == 0:
            d_src.append(2)
        else:
            d_src.append(4)
        if by == 0:
            c_src.append(2 if bx < 3 else 3)
        elif bx == 3:
            c_src.append(5)
        else:
            nb_z = POS_TO_ZSCAN[(bx + 1, by - 1)]
            c_src.append(0 if nb_z < blk else 5)
    return (np.array(a_src), np.array(b_src),
            np.array(c_src), np.array(d_src))


BLK4_A, BLK4_B, BLK4_C, BLK4_D = _blk4_avail_tables()
# 8x8 blocks (raster 0..3)
BLK8_A = np.array([1, 0, 1, 0])
BLK8_B = np.array([2, 2, 0, 0])
BLK8_C = np.array([2, 3, 0, 5])
BLK8_D = np.array([4, 2, 1, 0])


def _resolve_avail(src_code, mb_a, mb_b, mb_c, mb_d):
    if src_code == 0:
        return jnp.ones_like(mb_a)
    if src_code == 5:
        return jnp.zeros_like(mb_a)
    return [None, mb_a, mb_b, mb_c, mb_d][src_code]


def _avail_per_blk(src_codes, av_a, av_b, av_c, av_d):
    rows = [_resolve_avail(int(c), av_a, av_b, av_c, av_d) for c in src_codes]
    return jnp.stack(rows)


_ZPOS_J = jnp.asarray([[p[0], p[1]] for p in ZSCAN_4X4_POS], dtype=jnp.int32)

LW = 25   # luma window cols: x0-1 .. x0+23
LH = 17   # luma window rows: y0-1 .. y0+15


# ---------------------------------------------------------------------------
# per-diagonal MB batch reconstruction (shared by single-chip and banded)
# ---------------------------------------------------------------------------

def recon_mb_batch(x, kind, av_a, av_b, av_c, av_d, L, resid,
                   bitdepth=8):
    """Reconstruct a batch of MBs: all kinds computed branchlessly.

    L: local luma windows [K,LH,LW] (row 0 / col 0 = the -1 apron; interior
    initially arbitrary); resid: [K,16,16].  Returns out16 [K,16,16]."""
    maxv = (1 << bitdepth) - 1
    K = L.shape[0]

    # ---- I16 path -----------------------------------------------------
    above16 = L[:, 0, 1:17]
    left16 = L[:, 1:17, 0]
    corner = L[:, 0, 0]
    p16 = ipk.pred16x16_batch(x["i16_mode"], above16, left16, corner,
                              av_a, av_b, av_d, bitdepth)
    o16 = jnp.clip(p16 + resid, 0, maxv)

    # ---- I4 path (16 sequential sub-blocks on the local window) -------
    aa4 = _avail_per_blk(BLK4_A, av_a, av_b, av_c, av_d)  # [16,K]
    ab4 = _avail_per_blk(BLK4_B, av_a, av_b, av_c, av_d)
    ac4 = _avail_per_blk(BLK4_C, av_a, av_b, av_c, av_d)
    modes4 = x["modes4"]  # [K,16]

    def i4_body(blk, L4):
        bx = _ZPOS_J[blk, 0]
        by = _ZPOS_J[blk, 1]
        r0, c0 = 4 * by, 4 * bx
        row = jax.lax.dynamic_slice(L4, (0, r0, c0), (K, 1, 9))[:, 0, :]
        above8 = row[:, 1:9]
        above8 = jnp.concatenate([
            above8[:, :4],
            jnp.where(ac4[blk][:, None], above8[:, 4:8], above8[:, 3:4]),
        ], axis=1)
        colblk = jax.lax.dynamic_slice(L4, (0, r0, c0), (K, 5, 1))[:, :, 0]
        left4 = colblk[:, 1:5]
        corn = row[:, 0]
        pred = ipk.pred4x4_fast(modes4[:, blk], above8, left4, corn,
                                aa4[blk], ab4[blk], bitdepth)
        rblk = jax.lax.dynamic_slice(resid, (0, 4 * by, 4 * bx), (K, 4, 4))
        u = jnp.clip(pred + rblk, 0, maxv)
        return jax.lax.dynamic_update_slice(L4, u, (0, r0 + 1, c0 + 1))

    o4 = jax.lax.fori_loop(0, 16, i4_body, L)[:, 1:17, 1:17]

    # ---- I8 path (4 sequential 8x8 blocks) ----------------------------
    aa8 = _avail_per_blk(BLK8_A, av_a, av_b, av_c, av_d)
    ab8 = _avail_per_blk(BLK8_B, av_a, av_b, av_c, av_d)
    ac8 = _avail_per_blk(BLK8_C, av_a, av_b, av_c, av_d)
    ad8 = _avail_per_blk(BLK8_D, av_a, av_b, av_c, av_d)
    modes8 = x["modes8"]

    def i8_body(blk, L8):
        bx = blk & 1
        by = blk >> 1
        r0, c0 = 8 * by, 8 * bx
        row = jax.lax.dynamic_slice(L8, (0, r0, c0), (K, 1, 17))[:, 0, :]
        above = row[:, 1:17]
        above = jnp.concatenate([
            above[:, :8],
            jnp.where(ac8[blk][:, None], above[:, 8:16], above[:, 7:8]),
        ], axis=1)
        colblk = jax.lax.dynamic_slice(L8, (0, r0, c0), (K, 9, 1))[:, :, 0]
        left8 = colblk[:, 1:9]
        corn = row[:, 0]
        fa, fl, fz = ipk.filter8x8_fast(above, left8, corn,
                                        aa8[blk], ab8[blk], ad8[blk])
        pred = ipk.pred8x8_fast(modes8[:, blk], fa, fl, fz,
                                aa8[blk], ab8[blk], bitdepth)
        rblk = jax.lax.dynamic_slice(resid, (0, 8 * by, 8 * bx), (K, 8, 8))
        u = jnp.clip(pred + rblk, 0, maxv)
        return jax.lax.dynamic_update_slice(L8, u, (0, r0 + 1, c0 + 1))

    o8 = jax.lax.fori_loop(0, 4, i8_body, L)[:, 1:17, 1:17]

    # PCM samples were pre-merged into the residual tile
    return jnp.where((kind == KIND_PCM)[:, None, None], resid,
             jnp.where((kind == KIND_I16)[:, None, None], o16,
               jnp.where((kind == KIND_I8)[:, None, None], o8, o4)))


def recon_chroma_batch(x, kind, av_a, av_b, av_d, Cw, cresid,
                       bitdepth=8):
    """Chroma for a diagonal batch; Cw [K,2,9,9] windows (cb, cr).

    Returns [K,2,8,8]."""
    maxv = (1 << bitdepth) - 1
    outs = []
    for ci in range(2):
        W = Cw[:, ci]
        pc = ipk.pred_chroma_batch(x["chroma_mode"], W[:, 0, 1:9],
                                   W[:, 1:9, 0], W[:, 0, 0],
                                   av_a, av_b, av_d, bitdepth)
        oc = jnp.clip(pc + cresid[:, ci], 0, maxv)
        oc = jnp.where((kind == KIND_PCM)[:, None, None],
                       cresid[:, ci], oc)
        outs.append(oc)
    return jnp.stack(outs, axis=1)


# ---------------------------------------------------------------------------
# the frontier scan step (shared core)
# ---------------------------------------------------------------------------

DIAG_KEYS = ["kind", "i16_mode", "chroma_mode", "modes4", "modes8",
             "pcm_y", "pcm_c", "avail_a", "avail_b", "avail_c", "avail_d",
             "y_resid", "c_resid"]

# lane-aligned path: PCM is pre-merged into the residual tiles and tiles
# are emitted uint8, so the scan only streams this slim set per step
LANE_KEYS = ["kind", "i16_mode", "chroma_mode", "modes4", "modes8",
             "avail_a", "avail_b", "avail_c", "avail_d",
             "y_resid", "c_resid"]


def merge_pcm_and_slim(s):
    """Pre-merge PCM samples into residual tiles and clamp residuals.

    clamp(resid, -255, 255) preserves clip(pred + resid, 0, 255) for any
    pred in [0, 255], so residual tiles are safely int16.  PCM macroblocks
    place their raw samples in the residual tile; the step selects them
    directly (prediction bypassed).  A dict without pcm_y/pcm_c carries no
    PCM macroblocks."""
    y = jnp.clip(s["y_resid"], -255, 255)
    c = jnp.clip(s["c_resid"], -255, 255)
    if "pcm_y" in s:
        pcm = (s["kind"] == KIND_PCM)[:, None, None]
        y = jnp.where(pcm, s["pcm_y"], y)
        c = jnp.where(pcm[..., None], s["pcm_c"], c)
    out = dict(s)
    out["y_resid"] = y.astype(jnp.int16)
    out["c_resid"] = c.astype(jnp.int16)
    return out


def pack_diagonal(s, sched, mb_w, keys=None):
    """Pre-gather per-MB arrays into diagonal order [n_diag, K, ...] so the
    sequential scan consumes them as xs — no gathers in the hot loop."""
    addrs = jnp.maximum(sched, 0)
    xs = {k: s[k][addrs] for k in (keys or LANE_KEYS)}
    xs["valid"] = sched >= 0
    xs["mx"] = addrs % mb_w
    xs["my"] = addrs // mb_w
    return xs


def frontier_step(x, mb_w, state, halo=None, bitdepth=8):
    """One diagonal step over the frontier state.

    x: this diagonal's pre-packed lane data (see pack_diagonal) — all
    [K, ...], no dynamic indexing needed.
    state: dict with
      bot_cur [mb_w,16], bot_prev [mb_w,16], rcol [mb_h_local,16],
      cbot_cur [mb_w,2,8], cbot_prev [mb_w,2,8], crcol [mb_h_local,2,8]
    halo (banded mode): dict with bot_cur/cbot_cur from the band above,
    used for lanes on the band's first MB row.
    Returns (new_state, out16 [K,16,16], outc [K,2,8,8])."""
    valid = x["valid"]
    mx = x["mx"]
    my = x["my"]

    kind = x["kind"]
    av_a = x["avail_a"] & valid
    av_b = x["avail_b"] & valid
    av_c = x["avail_c"] & valid
    av_d = x["avail_d"] & valid

    bot_cur, bot_prev = state["bot_cur"], state["bot_prev"]
    rcol = state["rcol"]
    cbot_cur, cbot_prev = state["cbot_cur"], state["cbot_prev"]
    crcol = state["crcol"]

    mxl = jnp.maximum(mx - 1, 0)
    mxr = jnp.minimum(mx + 1, mb_w - 1)

    def sel_row(local, halo_arr):
        """Pick frontier row: halo for first-local-row lanes (banded)."""
        if halo is None or halo_arr is None:
            return local
        return jnp.where((my == 0)[:, None], halo_arr, local)

    above16 = sel_row(bot_cur[mx],
                      None if halo is None else halo["bot_cur"][mx])
    abover8 = sel_row(bot_cur[mxr][:, :8],
                      None if halo is None else halo["bot_cur"][mxr][:, :8])
    # corner: locally the column to the left was already overwritten by row
    # `my` (bot_prev holds row my-1); across a band boundary the neighbor
    # band's newest row IS its last row, so the halo corner uses bot_cur.
    corner = sel_row(bot_prev[mxl][:, 15:16],
                     None if halo is None else
                     halo["bot_cur"][mxl][:, 15:16])[:, 0]
    left16 = rcol[my]

    K = mx.shape[0]
    L = jnp.zeros((K, LH, LW), dtype=jnp.int32)
    L = L.at[:, 0, 0].set(corner)
    L = L.at[:, 0, 1:17].set(above16)
    L = L.at[:, 0, 17:25].set(abover8)
    L = L.at[:, 1:17, 0].set(left16)

    resid = x["y_resid"].astype(jnp.int32)   # [K,16,16] tiles
    out16 = recon_mb_batch(x, kind, av_a, av_b, av_c, av_d, L, resid,
                           bitdepth)

    # chroma windows
    cab = sel_row(cbot_cur[mx].reshape(K, 16),
                  None if halo is None else
                  halo["cbot_cur"][mx].reshape(K, 16)).reshape(K, 2, 8)
    ccorn = sel_row(cbot_prev[mxl][:, :, 7].reshape(K, 2),
                    None if halo is None else
                    halo["cbot_cur"][mxl][:, :, 7].reshape(K, 2))
    cleft = crcol[my]                # [K,2,8]
    Cw = jnp.zeros((K, 2, 9, 9), dtype=jnp.int32)
    Cw = Cw.at[:, :, 0, 0].set(ccorn)
    Cw = Cw.at[:, :, 0, 1:9].set(cab)
    Cw = Cw.at[:, :, 1:9, 0].set(cleft)
    cresid = x["c_resid"]            # [K,2,8,8]
    outc = recon_chroma_batch(x, kind, av_a, av_b, av_d, Cw, cresid,
                              bitdepth)

    # ---- frontier updates (small scatters; invalid lanes dropped) -----
    smx = jnp.where(valid, mx, mb_w + 7)
    smy = jnp.where(valid, my, rcol.shape[0] + 7)
    new_state = dict(state)
    new_state["bot_prev"] = bot_prev.at[smx].set(bot_cur[mx], mode="drop")
    new_state["bot_cur"] = bot_cur.at[smx].set(out16[:, 15, :], mode="drop")
    new_state["rcol"] = rcol.at[smy].set(out16[:, :, 15], mode="drop")
    new_state["cbot_prev"] = cbot_prev.at[smx].set(cbot_cur[mx], mode="drop")
    new_state["cbot_cur"] = cbot_cur.at[smx].set(outc[:, :, 7, :],
                                                 mode="drop")
    new_state["crcol"] = crcol.at[smy].set(outc[:, :, :, 7], mode="drop")
    return new_state, out16, outc


def init_frontier(mb_w: int, mb_h_local: int, zero=0):
    """zero: a traced scalar 0 derived from the input data, so the initial
    carry inherits any device-varying axes (shard_map vma tracking)."""
    z = zero * jnp.int32(0)
    return {
        "bot_cur": jnp.zeros((mb_w, 16), jnp.int32) + z,
        "bot_prev": jnp.zeros((mb_w, 16), jnp.int32) + z,
        "rcol": jnp.zeros((mb_h_local, 16), jnp.int32) + z,
        "cbot_cur": jnp.zeros((mb_w, 2, 8), jnp.int32) + z,
        "cbot_prev": jnp.zeros((mb_w, 2, 8), jnp.int32) + z,
        "crcol": jnp.zeros((mb_h_local, 2, 8), jnp.int32) + z,
    }


def tiles_to_planes(tiles_y, tiles_c, d_of, k_of, mb_w, mb_h):
    """tiles_y [n_diag,K,16,16], tiles_c [n_diag,K,2,8,8] -> planes."""
    ty = tiles_y[d_of, k_of]          # [n,16,16]
    y = ty.reshape(mb_h, mb_w, 16, 16).transpose(0, 2, 1, 3) \
          .reshape(mb_h * 16, mb_w * 16)
    tc = tiles_c[d_of, k_of]          # [n,2,8,8]
    c = tc.reshape(mb_h, mb_w, 2, 8, 8).transpose(2, 0, 3, 1, 4) \
          .reshape(2, mb_h * 8, mb_w * 8)
    return y, c[0], c[1]


def _shift_lanes(arr, s, K):
    """arr [K, ...] -> arr shifted by lane offset s (scalar, |s| <= 2)."""
    pad = jnp.pad(arr, ((2, 2),) + ((0, 0),) * (arr.ndim - 1))
    return jax.lax.dynamic_slice_in_dim(pad, 2 + s, K, axis=0)


def lane_step(x, K, state, bitdepth=8):
    """Lane-aligned frontier step: all neighbor aprons come from shifted
    slices of the previous three steps' outputs — no gather, no scatter.

    state: yb1/yb2/yb3 [K,16] (bottom rows of steps d-1/d-2/d-3),
    yr1 [K,16] (right cols of d-1), cb1/cb2/cb3 [K,2,8], cr1 [K,2,8]."""
    valid = x["valid"]
    kind = x["kind"]
    av_a = x["avail_a"] & valid
    av_b = x["avail_b"] & valid
    av_c = x["avail_c"] & valid
    av_d = x["avail_d"] & valid

    above16 = _shift_lanes(state["yb2"], x["s_ab"], K)
    abover8 = _shift_lanes(state["yb1"], x["s_ar"], K)[:, :8]
    corner = _shift_lanes(state["yb3"], x["s_cn"], K)[:, 15]
    left16 = _shift_lanes(state["yr1"], x["s_lf"], K)

    L = jnp.zeros((K, LH, LW), dtype=jnp.int32)
    L = L.at[:, 0, 0].set(corner)
    L = L.at[:, 0, 1:17].set(above16)
    L = L.at[:, 0, 17:25].set(abover8)
    L = L.at[:, 1:17, 0].set(left16)

    out16 = recon_mb_batch(x, kind, av_a, av_b, av_c, av_d, L,
                           x["y_resid"].astype(jnp.int32), bitdepth)

    cab = _shift_lanes(state["cb2"], x["s_ab"], K)
    ccorn = _shift_lanes(state["cb3"], x["s_cn"], K)[:, :, 7]
    cleft = _shift_lanes(state["cr1"], x["s_lf"], K)
    Cw = jnp.zeros((K, 2, 9, 9), dtype=jnp.int32)
    Cw = Cw.at[:, :, 0, 0].set(ccorn)
    Cw = Cw.at[:, :, 0, 1:9].set(cab)
    Cw = Cw.at[:, :, 1:9, 0].set(cleft)
    outc = recon_chroma_batch(x, kind, av_a, av_b, av_d, Cw,
                              x["c_resid"].astype(jnp.int32), bitdepth)

    new_state = {
        "yb1": out16[:, 15, :],
        "yb2": state["yb1"],
        "yb3": state["yb2"],
        "yr1": out16[:, :, 15],
        "cb1": outc[:, :, 7, :],
        "cb2": state["cb1"],
        "cb3": state["cb2"],
        "cr1": outc[:, :, :, 7],
    }
    return new_state, out16.astype(jnp.uint8), outc.astype(jnp.uint8)


def init_lane_state(K, zero=0):
    z = zero * jnp.int32(0)
    zr = jnp.zeros((K, 16), jnp.int32) + z
    zc = jnp.zeros((K, 2, 8), jnp.int32) + z
    return {"yb1": zr, "yb2": zr, "yb3": zr, "yr1": zr,
            "cb1": zc, "cb2": zc, "cb3": zc, "cr1": zc}


def make_wavefront_fn(mb_w: int, mb_h: int, bitdepth: int = 8,
                      return_tiles: bool = False):
    """Single-frame wavefront reconstruction as an XLA scan over the
    anti-diagonals (one lane_step per diagonal).

    Returns fn(syntax_dict, y_resid_tiles [n,16,16], c_resid_tiles
    [n,2,8,8]) -> (y, cb, cr) planes, or with return_tiles=True the raw
    diagonal-layout tiles (tiles_y [n_diag,K,16,16], tiles_c
    [n_diag,K,2,8,8]) for further wavefront passes (deblocking)."""
    sched_np, d_of, k_of = diag_schedule(mb_w, mb_h)
    s_ab, s_ar, s_lf, s_cn = diag_shifts(mb_w, mb_h)
    sched = jnp.asarray(sched_np)
    d_of = jnp.asarray(d_of)
    k_of = jnp.asarray(k_of)
    K = sched_np.shape[1]

    def run(syntax, y_resid_tiles, c_resid_tiles=None):
        s = dict(syntax)
        s["y_resid"] = y_resid_tiles
        s["c_resid"] = c_resid_tiles
        s = merge_pcm_and_slim(s)
        xs = pack_diagonal(s, sched, mb_w, LANE_KEYS)
        xs["s_ab"] = jnp.asarray(s_ab)
        xs["s_ar"] = jnp.asarray(s_ar)
        xs["s_lf"] = jnp.asarray(s_lf)
        xs["s_cn"] = jnp.asarray(s_cn)

        def step(state, x):
            state, out16, outc = lane_step(x, K, state, bitdepth)
            return state, (out16, outc)

        _, (tiles_y, tiles_c) = jax.lax.scan(
            step, init_lane_state(K, s["kind"][0]), xs)
        if return_tiles:
            return tiles_y, tiles_c
        return tiles_to_planes(tiles_y, tiles_c, d_of, k_of, mb_w, mb_h)

    return run


def make_gop_wavefront_fn(mb_w: int, mb_h: int, deblock: bool = False):
    """Reconstruction (+ in-loop deblocking) of F frames at once: the XLA
    reference of wavefront_kernel.make_gop_wavefront_kernel_fn.

    Returns fn(syntax [F,n,...], y_resid [F,n,16,16], c_resid
    [F,n,2,8,8], pre=None) -> (y, cb, cr) uint8 [F, H, W] planes; pre is
    the stacked [F, n, ...] edge-parameter dict (kernels.deblock
    PRE_KEYS) when deblock=True."""
    wf = make_wavefront_fn(mb_w, mb_h, return_tiles=True)
    _, d_of, k_of = diag_schedule(mb_w, mb_h)
    d_of = jnp.asarray(d_of)
    k_of = jnp.asarray(k_of)
    if deblock:
        from .deblock import make_deblock_tiles_fn
        dbfn = make_deblock_tiles_fn(mb_w, mb_h)

    def planes(ty, tc):
        return tiles_to_planes(ty, tc, d_of, k_of, mb_w, mb_h)

    def run(s, y_resid, c_resid, pre=None):
        ty, tc = jax.vmap(wf)(s, y_resid, c_resid)
        if deblock:
            ty, tc = jax.vmap(dbfn)(ty, tc, pre)
        return jax.vmap(planes)(ty, tc)

    return run
