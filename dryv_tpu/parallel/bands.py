"""Band-sharded wavefront reconstruction with halo exchange.

One frame's MB rows split into contiguous bands across the mesh "band"
axis.  The global anti-diagonal schedule still runs; each step every
device reconstructs its band's MBs of that diagonal, then ppermutes its
frontier bottom rows (per-MB-column newest bottom pixel rows — a few KB)
to the next band, where lanes on the band's first MB row read them as
their above/corner apron (SURVEY §5: ring-attention-style neighbor
exchange -> halo exchange of MB-boundary pixel rows between devices).

Freshness: an MB on diagonal d needs above-band pixels from neighbor-band
MBs on diagonals <= d-1 (above-right); the exchange at the end of every
step delivers them before step d starts."""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import jax
import jax.numpy as jnp

from ..kernels.wavefront import (
    diag_schedule, frontier_step, init_frontier, pack_diagonal,
    tiles_to_planes)


@lru_cache(maxsize=None)
def band_schedule(mb_w: int, mb_h: int, n_bands: int):
    """Per-band diagonal schedule with band-LOCAL MB addresses, plus the
    inverse maps for local tile->plane assembly.

    Returns (rows, sched [n_bands, n_diag, K], d_of [n_bands, n_local],
    k_of [n_bands, n_local])."""
    rows = -(-mb_h // n_bands)
    n_diag = mb_w + 2 * (mb_h - 1)
    diags = [[[] for _ in range(n_diag)] for _ in range(n_bands)]
    for my in range(mb_h):
        b = my // rows
        for mx in range(mb_w):
            diags[b][mx + 2 * my].append((my - b * rows) * mb_w + mx)
    K = max((len(v) for band in diags for v in band), default=1)
    n_local = rows * mb_w
    sched = np.full((n_bands, n_diag, K), -1, dtype=np.int32)
    d_of = np.zeros((n_bands, n_local), dtype=np.int32)
    k_of = np.zeros((n_bands, n_local), dtype=np.int32)
    for b in range(n_bands):
        for d in range(n_diag):
            sched[b, d, :len(diags[b][d])] = diags[b][d]
            for k, a in enumerate(diags[b][d]):
                d_of[b, a] = d
                k_of[b, a] = k
    return rows, sched, d_of, k_of


def make_banded_frame_fn(mesh, mb_w: int, mb_h: int, axis: str = "band",
                         bitdepth: int = 8):
    """jitted full-frame band-sharded reconstruction.

    Call the returned `run(fs)` with an (unpadded) FrameSyntax; it pads MB
    rows to a multiple of the band count, shards syntax + residual stage
    over the mesh axis, runs the halo-exchanging wavefront, and returns
    cropped numpy planes."""
    from jax.sharding import PartitionSpec as P
    from ..pipeline import SYNTAX_KEYS
    from ..kernels.transform import (
        LS4_FLAT, LS8_FLAT, chroma_residual_tiles, luma_residual_tiles)

    n_bands = mesh.shape[axis]
    rows, sched_np, d_of_np, k_of_np = band_schedule(mb_w, mb_h, n_bands)
    n_local = rows * mb_w
    perm = [(i, i + 1) for i in range(n_bands - 1)]

    def local(s, sched, d_of, k_of):
        sched = sched[0]
        d_of = d_of[0]
        k_of = k_of[0]
        s = dict(s)
        s["y_resid"] = luma_residual_tiles(
            s["kind"], s["qp_y"], s["luma4"], s["luma8"], s["luma_dc"],
            n_local, jnp.asarray(LS4_FLAT), jnp.asarray(LS8_FLAT))
        s["c_resid"] = chroma_residual_tiles(
            s["qp_cb"], s["qp_cr"], s["chroma_dc"], s["chroma_ac"], n_local,
            jnp.asarray(LS4_FLAT), jnp.asarray(LS4_FLAT))

        halo0 = {
            "bot_cur": jnp.zeros((mb_w, 16), jnp.int32),
            "cbot_cur": jnp.zeros((mb_w, 2, 8), jnp.int32),
        }

        def mark_varying(tree):
            # the scan carry becomes device-varying after the ppermute;
            # mark the initial value to match
            return jax.tree.map(
                lambda x: jax.lax.pcast(x, axis, to="varying"), tree)

        def step(carry, x):
            state, halo = carry
            state, out16, outc = frontier_step(
                x, mb_w, state, halo, bitdepth)
            # exchange frontier bottom rows to the next band
            halo = {
                "bot_cur": jax.lax.ppermute(state["bot_cur"], axis, perm),
                "cbot_cur": jax.lax.ppermute(state["cbot_cur"], axis, perm),
            }
            return (state, halo), (out16, outc)

        from ..kernels.wavefront import merge_pcm_and_slim, LANE_KEYS
        s = merge_pcm_and_slim(s)
        xs = pack_diagonal(s, sched, mb_w, LANE_KEYS)
        (_, _), (tiles_y, tiles_c) = jax.lax.scan(
            step, mark_varying((init_frontier(mb_w, rows), halo0)), xs)
        return tiles_to_planes(tiles_y, tiles_c, d_of, k_of, mb_w, rows)

    spec = P(axis)
    fn = jax.shard_map(local, mesh=mesh,
                       in_specs=({k: spec for k in SYNTAX_KEYS}, spec, spec,
                                 spec),
                       out_specs=(spec, spec, spec))
    jfn = jax.jit(fn)

    def run(fs):
        n_pad = n_bands * n_local
        s = {}
        for k in SYNTAX_KEYS:
            arr = np.asarray(getattr(fs, k))
            if arr.shape[0] != n_pad:
                pad = np.zeros((n_pad - arr.shape[0],) + arr.shape[1:],
                               arr.dtype)
                arr = np.concatenate([arr, pad])
            s[k] = arr
        y, cb, cr = jfn(s, sched_np, d_of_np, k_of_np)
        H = mb_h * 16
        return (np.asarray(y)[:H], np.asarray(cb)[:H // 2],
                np.asarray(cr)[:H // 2])

    return run


def make_banded_wavefront_fn(*a, **kw):  # back-compat alias
    return make_banded_frame_fn(*a, **kw)


# ---------------------------------------------------------------------------
# Banded P-frame reconstruction: reference-plane halo exchange for inter
# prediction (the last SURVEY 2.10 partial).  Motion vectors reach into
# neighbor bands' reference pixels; each band ppermutes an apron of its
# top/bottom reference rows to its neighbors (MV reach is bounded by the
# level's vertical MV limit, so the apron height is a static bound the
# host asserts), then motion-compensates its own blocks entirely locally.
# The reference decoder has no inter reconstruction and no multi-device
# story at all (frame/mod.rs:88, SURVEY 2.10).
# ---------------------------------------------------------------------------

def make_banded_p_recon_fn(mesh, mb_w: int, mb_h: int, apron: int,
                           axis: str = "band"):
    """Returns run(ref_y, ref_cb, ref_cr, mv [n4,2], rs [n4], y_resid
    [n,16,16], c_resid [n,2,8,8]) -> (y, cb, cr) uint8 planes for a
    single-reference P picture with no intra MBs.

    Planes and per-block arrays shard along MB rows over the mesh's
    `axis`; each device receives `apron` extra reference rows from each
    neighbor band (one ppermute pair) and runs quarter-pel MC +
    residual add locally.  Vertical MV integer reach (plus the 6-tap
    margin) must stay within `apron` — the caller asserts this against
    the level's vertical MV range."""
    from jax.sharding import PartitionSpec as P

    from ..kernels.inter import mc_luma_blocks, mc_chroma_blocks

    n_bands = mesh.shape[axis]
    assert mb_h % n_bands == 0, "bands must split MB rows evenly"
    hb_mb = mb_h // n_bands
    H, W = mb_h * 16, mb_w * 16
    Hb = hb_mb * 16                      # luma rows per band
    Hcb = Hb // 2
    A = apron
    Ac = A // 2
    W4 = mb_w * 4

    def local(ry, rcb, rcr, mv, rs, y_resid, c_resid):
        b = jax.lax.axis_index(axis)
        down = [(i, (i + 1) % n_bands) for i in range(n_bands)]
        up = [(i, (i - 1) % n_bands) for i in range(n_bands)]

        def ext_plane(p, a, hb, htot):
            """Extended local plane [a + hb + a, W]: aprons gathered from
            ceil(a/hb) neighbor bands in each direction (chained
            ppermutes), then remapped so rows outside the frame
            replicate the frame edge — which makes the extended-plane
            row clamp EXACTLY the global row clamp (same argument as
            edge-padded window gathers)."""
            pl = p[0]
            k = -(-a // hb)
            segs_up, segs_dn = [], []
            cur_u = cur_d = pl
            for _ in range(k):
                cur_u = jax.lax.ppermute(cur_u, axis, down)
                segs_up.insert(0, cur_u)
                cur_d = jax.lax.ppermute(cur_d, axis, up)
                segs_dn.append(cur_d)
            ext = jnp.concatenate(segs_up + [pl] + segs_dn, axis=0)
            ext = ext[k * hb - a:k * hb + hb + a]
            row0 = b * hb
            g = jnp.arange(hb + 2 * a) + row0 - a
            idx = jnp.clip(g, 0, htot - 1) - (row0 - a)
            return jnp.take(ext, jnp.clip(idx, 0, hb + 2 * a - 1), axis=0)

        ey = ext_plane(ry, A, Hb, H).astype(jnp.int32)
        ecb = ext_plane(rcb, Ac, Hcb, H // 2).astype(jnp.int32)
        ecr = ext_plane(rcr, Ac, Hcb, H // 2).astype(jnp.int32)

        n4l = mv.shape[0]                # blocks in this band
        idx = jnp.arange(n4l, dtype=jnp.int32)
        bx4 = idx % W4
        by4 = idx // W4                  # band-LOCAL block rows
        # localize by shifting the block grid: the extended plane starts
        # A pixel rows (A//4 block rows) above the band, so the shared
        # MC helpers compute exactly the globally-clamped windows as
        # long as the vertical reach stays within the apron (asserted
        # in run())
        by4_l = by4 + A // 4
        zero_rs = jnp.zeros(n4l, jnp.int32)
        p0y = mc_luma_blocks(ey.reshape(-1), zero_rs, mv, bx4, by4_l,
                             Hb + 2 * A, W)
        p0cb = mc_chroma_blocks(ecb.reshape(-1), zero_rs, mv, bx4, by4_l,
                                Hcb + 2 * Ac, W // 2)
        p0cr = mc_chroma_blocks(ecr.reshape(-1), zero_rs, mv, bx4, by4_l,
                                Hcb + 2 * Ac, W // 2)
        use = (rs[:, None, None] >= 0)
        py = jnp.where(use, p0y, 0)
        pcb = jnp.where(use, p0cb, 0)
        pcr = jnp.where(use, p0cr, 0)

        nl = hb_mb * mb_w
        pred_y = (py.reshape(hb_mb, 4, mb_w, 4, 4, 4)
                  .transpose(0, 2, 1, 4, 3, 5).reshape(nl, 16, 16))
        pc = jnp.stack([pcb, pcr], axis=1)
        pred_c = (pc.reshape(hb_mb, 4, mb_w, 4, 2, 2, 2)
                  .transpose(0, 2, 4, 1, 5, 3, 6).reshape(nl, 2, 8, 8))
        ty = jnp.clip(pred_y + y_resid, 0, 255).astype(jnp.uint8)
        tc = jnp.clip(pred_c + c_resid, 0, 255).astype(jnp.uint8)
        yp = (ty.reshape(hb_mb, mb_w, 16, 16).transpose(0, 2, 1, 3)
              .reshape(Hb, W))
        cbp = (tc[:, 0].reshape(hb_mb, mb_w, 8, 8).transpose(0, 2, 1, 3)
               .reshape(Hcb, W // 2))
        crp = (tc[:, 1].reshape(hb_mb, mb_w, 8, 8).transpose(0, 2, 1, 3)
               .reshape(Hcb, W // 2))
        return yp[None], cbp[None], crp[None]

    spec = P(axis)
    fn = jax.shard_map(local, mesh=mesh,
                       in_specs=(P(None, axis), P(None, axis), P(None, axis),
                                 spec, spec, spec, spec),
                       out_specs=(P(None, axis), P(None, axis),
                                  P(None, axis)))
    jfn = jax.jit(fn)

    def run(ref_y, ref_cb, ref_cr, mv, rs, y_resid, c_resid):
        # MV vertical reach check: integer rows + 6-tap margin within A
        reach = int(np.max(np.abs(np.asarray(mv)[:, 1]))) // 4 + 9
        assert reach <= A, f"vertical MV reach {reach} exceeds apron {A}"
        y, cb, cr = jfn(jnp.asarray(ref_y)[None], jnp.asarray(ref_cb)[None],
                        jnp.asarray(ref_cr)[None], jnp.asarray(mv),
                        jnp.asarray(rs), jnp.asarray(y_resid),
                        jnp.asarray(c_resid))
        return np.asarray(y[0]), np.asarray(cb[0]), np.asarray(cr[0])

    return run
