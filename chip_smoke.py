#!/usr/bin/env python3
"""Chip smoke test: the decoder's main paths, once, on one GPU at 1080p.

Run from the repository root on a machine with an NVIDIA GPU:

    python chip_smoke.py            # every phase, one card
    python chip_smoke.py --multi    # gop + band sharding on 4 cards only

Phases (each failure propagates; nothing is caught):
  0 preflight  card (nvidia-smi), JAX version and devices, native build
  1 cli        python -m dryv_tpu on an MP4 muxed from the 1080p GOP
               stream, plain and with --stats
  2 gop        gop_pipeline.decode_annexb_gop_pipelined, 16 frames
  3 goldens    1080p intra with and without deblocking, per-picture and
               batched device paths, against the committed goldens
  4 ipb        the packed device I/P/B path at 1080p and 640x368
  5 wavefront  the wavefront kernel against the XLA scan reference:
               bit-exact check and median times at 1080p, F=16
  6 memory     peak device memory and the GOP program's memory analysis

Every comparison is exact (integer samples, tolerance 0) against the
committed libavcodec goldens or the native C++ decode, which the CPU test
suite holds bit-exact to libavcodec.  The last stdout line is one JSON
object naming the device; the script exits non-zero without printing it
when JAX finds no GPU.  The phase functions take ``interpret`` so the
CPU test suite can rehearse them with the kernel in interpret mode.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
BENCH = os.path.join(HERE, "benchdata")
OUT_DIR = os.path.join(HERE, "chiprun_out", "smoke")


def check(ok: bool, msg: str) -> None:
    """A failed check ends the run (unlike assert, also under -O)."""
    if not ok:
        raise AssertionError(msg)


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def read(name: str) -> bytes:
    with open(os.path.join(BENCH, name), "rb") as f:
        return f.read()


def card_line() -> str:
    """The card's name and power limit, from a child that never touches
    JAX (so it holds no device memory)."""
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60, check=True)
    return r.stdout.strip()


def native_frames(stream: bytes):
    from dryv_tpu.native.full import decode_annexb_native
    return [(f.y, f.cb, f.cr) for f in decode_annexb_native(stream)]


def assert_frames(tag: str, got, ref) -> None:
    """got/ref: sequences of (y, cb, cr); got may be uncropped device
    planes (cropped to ref's shape)."""
    check(len(got) == len(ref), f"{tag}: {len(got)} frames, want {len(ref)}")
    for i, (g, r) in enumerate(zip(got, ref)):
        for name, gp, rp in zip(("y", "cb", "cr"), g, r):
            gp = np.asarray(gp)[:rp.shape[0], :rp.shape[1]]
            check(np.array_equal(gp, rp), f"{tag}: frame {i} {name} differs")


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_preflight() -> dict:
    import jax

    from dryv_tpu.native.build import build
    from dryv_tpu.utils.compile_cache import setup_compile_cache

    log("preflight", f"card: {card_line()}")
    log("preflight", f"jax {jax.__version__}, devices {jax.devices()}")
    d = jax.devices()[0]
    if d.platform != "gpu":
        raise SystemExit(f"no GPU: JAX found {jax.devices()}")
    t0 = time.perf_counter()
    lib = build()
    log("preflight", f"native library {os.path.basename(lib)} ready in "
        f"{time.perf_counter() - t0:.3f} s (set-up)")
    log("preflight", f"compile cache: {setup_compile_cache()}")
    return {"platform": d.platform, "kind": d.device_kind,
            "count": len(jax.devices())}


def phase_cli(stream: bytes, frames: int, workdir: str,
              interpret: bool = False) -> None:
    """Mux the Annex-B stream into an MP4 and decode it with the CLI,
    plain (per-picture device path) and with --stats (GOP pipeline)."""
    from dryv_tpu.avc import NalUnitType, split_annexb
    from dryv_tpu.avc.nal import to_avcc_sample
    from dryv_tpu.avc.sps import SPS
    from dryv_tpu.cli import main as cli_main
    from dryv_tpu.container import write_mp4
    from dryv_tpu.decoder import group_access_units

    os.makedirs(workdir, exist_ok=True)
    nals = list(split_annexb(stream))
    sps_nal = next(n for n in nals if n.type == NalUnitType.SPS)
    pps_nal = next(n for n in nals if n.type == NalUnitType.PPS)
    slices = [n for n in nals if n.type in (NalUnitType.IDR_SLICE,
                                            NalUnitType.NON_IDR_SLICE)]
    samples = [to_avcc_sample(au) for au in group_access_units(slices)]
    sps = SPS.parse(sps_nal.rbsp)
    mp4 = os.path.join(workdir, "cli_input.mp4")
    write_mp4(mp4, samples, sps_nal.to_bytes(), pps_nal.to_bytes(),
              sps.width, sps.height)
    ry, rcb, rcr = native_frames(stream)[0]
    want = ry.tobytes() + rcb.tobytes() + rcr.tobytes()
    for extra in ([], ["--stats"]):
        out = os.path.join(workdir, "cli_out.yuv")
        t0 = time.perf_counter()
        rc = cli_main([mp4, "-o", out, "--backend", "jax",
                       "--frames", str(frames)] + extra
                      + (["--interpret"] if interpret else []))
        check(rc == 0, f"cli exit {rc}")
        with open(out, "rb") as f:
            got = f.read()
        check(got == want, f"cli {extra}: YUV differs from native decode")
        log("cli", f"{' '.join(extra) or 'plain'}: {len(got)} bytes "
            f"bit-exact in {time.perf_counter() - t0:.2f} s")


def phase_gop(stream: bytes, gop: int, platform: str = "gpu",
              interpret: bool = False) -> None:
    import jax

    from dryv_tpu.gop_pipeline import decode_annexb_gop_pipelined
    from dryv_tpu.utils.obs import StageTimers

    ref = native_frames(stream)
    tm = StageTimers()
    t0 = time.perf_counter()
    # stacked_out refuses the per-picture fallback, so a result here
    # means the batched device path ran
    batches = decode_annexb_gop_pipelined(stream, gop=gop,
                                          stacked_out=True, timers=tm,
                                          interpret=interpret)
    jax.block_until_ready([b[:3] for b in batches])
    dt = time.perf_counter() - t0
    got = []
    for y, cb, cr, nf in batches:
        for arr in (y, cb, cr):
            plats = {d.platform for d in arr.devices()}
            check(plats == {platform}, f"output on {plats}")
        got += [(y[i], cb[i], cr[i]) for i in range(nf)]
    check(tm.counters["frames"] == len(ref), f"frames {tm.counters}")
    assert_frames("gop", got, ref)
    log("gop", f"{len(got)} frames in {len(batches)} batch(es) of {gop}, "
        f"bit-exact, on {platform}, {dt:.2f} s incl. compile; stages "
        f"{json.dumps(tm.report())}")


def phase_goldens(cases, interpret: bool = False) -> None:
    """cases: [(name, stream, (gy, gcb, gcr))] single-picture intra
    streams, run through the per-picture and the batched device paths."""
    from dryv_tpu.gop_pipeline import decode_annexb_gop_pipelined
    from dryv_tpu.pipeline import decode_annexb_fast

    for name, stream, golden in cases:
        f = decode_annexb_fast(stream, interpret=interpret)
        assert_frames(f"{name} per-picture", [(x.y, x.cb, x.cr) for x in f],
                      [golden])
        b = decode_annexb_gop_pipelined(stream, gop=1, stacked_out=True,
                                        interpret=interpret)
        assert_frames(f"{name} batched", [(b[0][0][0], b[0][1][0],
                                           b[0][2][0])], [golden])
        log("goldens", f"{name}: per-picture and batched paths bit-exact")


def phase_ipb(native_stream: bytes, golden_stream: bytes, golden,
              interpret: bool = False) -> None:
    """golden: the bench_ipb_golden.npz mapping (f{i}_y/_b/_r)."""
    from dryv_tpu.device_ipb_packed import decode_annexb_device_packed

    t0 = time.perf_counter()
    got = decode_annexb_device_packed(native_stream, interpret=interpret)
    assert_frames("ipb vs native", [(f.y, f.cb, f.cr) for f in got],
                  native_frames(native_stream))
    log("ipb", f"{len(got)} frames vs native decode bit-exact, "
        f"{time.perf_counter() - t0:.2f} s incl. compile")
    got = decode_annexb_device_packed(golden_stream, interpret=interpret)
    ref = [(golden[f"f{i}_y"], golden[f"f{i}_b"], golden[f"f{i}_r"])
           for i in range(len(got))]
    assert_frames("ipb vs golden", [(f.y, f.cb, f.cr) for f in got], ref)
    log("ipb", f"{len(got)} frames vs golden bit-exact")


def gop_inputs(stream: bytes, F: int):
    """Wavefront inputs for the first F pictures of an intra stream:
    ((mb_w, mb_h), syntax dict [F, n, ...], y_resid, c_resid)."""
    import jax
    import jax.numpy as jnp

    from dryv_tpu.coeffs import pack_from_native
    from dryv_tpu.gop_pipeline import (_parse_pictures, compact_stage_a,
                                       stack_gop_compact)
    from dryv_tpu.kernels.transform import LS4_FLAT, LS8_FLAT
    from dryv_tpu.native.entropy import decode_picture_islices

    pics, sps, pps = _parse_pictures(stream)
    fs = [pack_from_native(decode_picture_islices(sd, sps, pps), sps, pps)
          for sd, _ in pics[:F]]
    fs += [fs[-1]] * (F - len(fs))
    s = {k: jnp.asarray(v) for k, v in stack_gop_compact(fs).items()}
    ls = [jnp.asarray(LS4_FLAT)] * 3 + [jnp.asarray(LS8_FLAT)]
    wf, y_resid, c_resid = jax.jit(compact_stage_a)(s, *ls)
    return (fs[0].mb_w, fs[0].mb_h), wf, y_resid, c_resid


def median_time(fn, args, runs: int) -> float:
    import jax
    jax.block_until_ready(fn(*args))          # warm (compile)
    ts = []
    for _ in range(runs):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return statistics.median(ts)


def phase_wavefront(stream: bytes, F: int, runs: int,
                    interpret: bool = False) -> dict:
    """The wavefront kernel against its plain reference, the XLA scan:
    bit-exact on F real frames, then both timed on the same inputs."""
    import jax

    from dryv_tpu.kernels.wavefront import make_gop_wavefront_fn
    from dryv_tpu.kernels.wavefront_kernel import (
        make_gop_wavefront_kernel_fn)

    (mb_w, mb_h), wf, y_resid, c_resid = gop_inputs(stream, F)
    args = (wf, y_resid, c_resid)
    kernel = jax.jit(make_gop_wavefront_kernel_fn(mb_w, mb_h,
                                                  interpret=interpret))
    xla = jax.jit(make_gop_wavefront_fn(mb_w, mb_h))
    ref = [np.asarray(p) for p in xla(*args)]
    assert_frames("kernel vs XLA scan", list(zip(*kernel(*args))),
                  list(zip(*ref)))
    t_k = median_time(kernel, args, runs)
    t_x = median_time(xla, args, runs)
    log("wavefront", f"{mb_w}x{mb_h} MBs, F={F}, bit-exact; median of "
        f"{runs} warm runs: kernel {t_k * 1e3:.3f} ms, XLA scan "
        f"{t_x * 1e3:.3f} ms; the pipelines run the kernel")
    return {"kernel_ms": t_k * 1e3, "xla_scan_ms": t_x * 1e3}


def phase_memory(stream: bytes, F: int, interpret: bool = False) -> None:
    """Peak device memory so far, and the memory analysis of the GOP
    pipeline's program (densify + stage A + wavefront kernel) at the
    pipeline's starting wire capacities."""
    import jax

    from dryv_tpu.gop_pipeline import (_BLOB_SPEC, _parse_pictures,
                                       make_packed_gop_fn)
    from dryv_tpu.kernels.densify import BLK, round_up
    from dryv_tpu.kernels.transform import LS4_FLAT, LS8_FLAT

    pics, sps, pps = _parse_pictures(stream)
    mb_w, mb_h = sps.pic_width_in_mbs, sps.frame_height_in_mbs
    n = mb_w * mb_h
    W, ecap, ovcap = 32, 256, 64
    deblocked = any(h.deblocking is None or h.deblocking.disable_idc != 1
                    for _, hs in pics for h in hs)
    fn = make_packed_gop_fn(mb_w, mb_h, F, deblocked,
                            pps.chroma_qp_index_offset,
                            pps.second_chroma_qp_offset, W, ecap, ovcap,
                            interpret)
    args = [jax.ShapeDtypeStruct(shape_of(F, round_up(n, BLK), n, W, ecap,
                                          ovcap), dt)
            for _, dt, shape_of in _BLOB_SPEC]
    args += [jax.ShapeDtypeStruct(t.shape, t.dtype)
             for t in (LS4_FLAT, LS4_FLAT, LS4_FLAT, LS8_FLAT)]
    compiled = fn.lower(*args).compile()
    log("memory", f"GOP program (F={F}, W={W}): "
        f"{compiled.memory_analysis()}")
    stats = jax.devices()[0].memory_stats() or {}
    log("memory", f"peak_bytes_in_use {stats.get('peak_bytes_in_use')}")


def phase_multi(stream: bytes, n_dev: int, interpret: bool = False) -> None:
    """gop sharding (16 frames over {"gop": n}) and band sharding (one
    frame over {"band": n}) against the single-device GOP pipeline."""
    from dryv_tpu.coeffs import pack_from_native
    from dryv_tpu.gop_pipeline import (_parse_pictures,
                                       decode_annexb_gop_pipelined)
    from dryv_tpu.native.entropy import decode_picture_islices
    from dryv_tpu.parallel import make_mesh
    from dryv_tpu.parallel.bands import make_banded_frame_fn
    from dryv_tpu.parallel.gop import decode_gop_sharded

    ref = [(f.y, f.cb, f.cr)
           for f in decode_annexb_gop_pipelined(stream, interpret=interpret)]
    pics, sps, pps = _parse_pictures(stream)
    # the sharded paths reconstruct without the in-loop filter
    check(all(h.deblocking is not None and h.deblocking.disable_idc == 1
              for _, hs in pics for h in hs), "stream enables deblocking")
    fs = [pack_from_native(decode_picture_islices(sd, sps, pps), sps, pps)
          for sd, _ in pics]
    t0 = time.perf_counter()
    y, cb, cr = decode_gop_sharded(fs, make_mesh({"gop": n_dev}),
                                   interpret=interpret)
    assert_frames("gop-sharded", list(zip(y, cb, cr)), ref)
    log("multi", f"gop sharding over {n_dev} devices: {len(fs)} frames "
        f"bit-exact, {time.perf_counter() - t0:.2f} s incl. compile")
    t0 = time.perf_counter()
    run = make_banded_frame_fn(make_mesh({"band": n_dev}), fs[0].mb_w,
                               fs[0].mb_h)
    assert_frames("band-sharded", [run(fs[0])], ref[:1])
    log("multi", f"band sharding over {n_dev} devices: 1 frame bit-exact, "
        f"{time.perf_counter() - t0:.2f} s incl. compile")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--multi", action="store_true",
                    help="run only the 4-card gop/band sharding phase")
    args = ap.parse_args(argv)
    device = phase_preflight()
    gop16 = read("bench1080p_gop16.264")
    if args.multi:
        check(device["count"] >= 4, f"--multi needs 4 GPUs: {device}")
        phase_multi(gop16, 4)
    else:
        phase_cli(gop16, 16, OUT_DIR)
        phase_gop(gop16, 16)
        phase_goldens([
            (name, read(f"{name}.264"),
             tuple(np.load(os.path.join(BENCH, f"{name}_golden.npz"))[k]
                   for k in ("y", "cb", "cr")))
            for name in ("bench1080p", "bench1080p_dblk")])
        phase_ipb(read("bench1080p_ipb.264"), read("bench_ipb.264"),
                  np.load(os.path.join(BENCH, "bench_ipb_golden.npz")))
        phase_wavefront(gop16, 16, 10)
        phase_memory(gop16, 16)
    print(card_line())
    print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
