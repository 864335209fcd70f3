"""CLI driver (reference src/main.rs + src/cli.rs).

Usage: python -m dryv_tpu <file.mp4> [-d] [-o OUT] [--frames N]
       [--backend jax|device-ipb|native|scalar] [--stats] [--interpret]
"""
from __future__ import annotations

import argparse
import logging
import time


def main(argv=None):
    ap = argparse.ArgumentParser(prog="dryv",
                                 description="H.264/AVC decode engine")
    ap.add_argument("filepath")
    ap.add_argument("-d", "--debug", action="store_true")
    ap.add_argument("-o", "--output", default="temp/yuv_frame",
                    help="YUV output path (reference writes temp/yuv_frame)")
    ap.add_argument("--frames", type=int, default=1)
    ap.add_argument("--backend", choices=("jax", "device-ipb", "native", "scalar"),
                    default="jax")
    ap.add_argument("-s", "--seek", default=None,
                    help="seek position: Ns | Nms | N%% | Nts")
    ap.add_argument("--stats", action="store_true",
                    help="print per-stage timing (demux/entropy/pack/"
                         "dispatch) as JSON after decoding")
    ap.add_argument("--interpret", action="store_true",
                    help="run the device wavefront kernel in Pallas "
                         "interpret mode (for machines without a GPU)")
    args = ap.parse_args(argv)

    logging.basicConfig(
        level=logging.DEBUG if args.debug else logging.INFO,
        format="%(levelname).1s %(name)s %(message)s")
    if args.debug:
        fh = logging.FileHandler("debug.log", mode="w")
        logging.getLogger().addHandler(fh)

    from .utils.compile_cache import setup_compile_cache
    from .video import Video

    setup_compile_cache()
    t0 = time.time()
    v = Video.open(args.filepath)
    info = v.info()
    for k, val in info.items():
        print(f"{k}: {val}")
    tm = None
    if args.stats:
        from .utils.obs import StageTimers
        tm = StageTimers()
    frames = v.decode_frames(max_frames=args.frames, backend=args.backend,
                             timers=tm, interpret=args.interpret)
    if frames:
        import os
        os.makedirs(os.path.dirname(args.output) or ".", exist_ok=True)
        v.write_yuv(args.output, frames[0])
        print(f"wrote {args.output} "
              f"({frames[0].y.shape[1]}x{frames[0].y.shape[0]})")
    if tm is not None:
        import json
        print("stats:", json.dumps(tm.report()))
    print(f"Done in {time.time() - t0:.3f}s")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
