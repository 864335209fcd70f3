"""Frame-parallel GOP decode: intra frames are fully independent, so a GOP
shards over the mesh "gop" axis; each device reconstructs its frames with
the single-device pipeline (stage A + the wavefront kernel).
"""
from __future__ import annotations

from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from ..pipeline import SYNTAX_KEYS
from ..kernels.transform import (
    LS4_FLAT, LS8_FLAT, chroma_residual_tiles, luma_residual_tiles)


def stack_frames(fs_list):
    """Stack per-frame FrameSyntax tensors into [F, ...] arrays."""
    out = {}
    for k in SYNTAX_KEYS:
        out[k] = np.stack([np.asarray(getattr(f, k)) for f in fs_list])
    return out


@lru_cache(maxsize=None)
def make_gop_recon_fn(mesh: Mesh, mb_w: int, mb_h: int, axis: str = "gop",
                      interpret: bool = False):
    """jitted fn: stacked syntax [F,...] (F divisible by mesh axis size)
    -> (y[F,H,W], cb, cr), frames sharded over `axis`; every shard runs
    the wavefront kernel once over its frames."""
    from ..kernels.wavefront_kernel import make_gop_wavefront_kernel_fn

    n = mb_w * mb_h
    recon = make_gop_wavefront_kernel_fn(mb_w, mb_h, False, interpret)

    def local(s):  # s: local shard [F_local, ...]
        F = s["kind"].shape[0]
        M = F * n
        flat = {k: v.reshape((M,) + v.shape[2:]) for k, v in s.items()}
        y_resid = luma_residual_tiles(
            flat["kind"], flat["qp_y"], flat["luma4"], flat["luma8"],
            flat["luma_dc"], M, jnp.asarray(LS4_FLAT), jnp.asarray(LS8_FLAT))
        c_resid = chroma_residual_tiles(
            flat["qp_cb"], flat["qp_cr"], flat["chroma_dc"],
            flat["chroma_ac"], M, jnp.asarray(LS4_FLAT),
            jnp.asarray(LS4_FLAT))
        wf = {k: s[k] for k in SYNTAX_KEYS if k not in
              ("qp_y", "qp_cb", "qp_cr", "luma4", "luma8", "luma_dc",
               "chroma_dc", "chroma_ac")}
        return recon(wf, y_resid.reshape(F, n, 16, 16),
                     c_resid.reshape(F, n, 2, 8, 8))

    spec = P(axis)
    # check_vma off: pallas_call outputs carry no varying-mesh-axes
    # annotation; the gop axis is embarrassingly parallel (no collectives)
    fn = jax.shard_map(local, mesh=mesh,
                       in_specs=({k: spec for k in SYNTAX_KEYS},),
                       out_specs=(spec, spec, spec), check_vma=False)
    return jax.jit(fn)


def decode_gop_sharded(fs_list, mesh: Mesh, axis: str = "gop",
                       interpret: bool = False):
    """Decode a list of FrameSyntax (same geometry) sharded over the mesh."""
    assert fs_list, "empty GOP"
    mb_w, mb_h = fs_list[0].mb_w, fs_list[0].mb_h
    n_dev = mesh.shape[axis]
    pad = (-len(fs_list)) % n_dev
    padded = list(fs_list) + [fs_list[-1]] * pad
    stacked = stack_frames(padded)
    fn = make_gop_recon_fn(mesh, mb_w, mb_h, axis, interpret)
    y, cb, cr = fn(stacked)
    F = len(fs_list)
    return np.asarray(y[:F]), np.asarray(cb[:F]), np.asarray(cr[:F])
