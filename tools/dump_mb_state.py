#!/usr/bin/env python
"""Per-picture macroblock-state dump for desync bisection.

The reference dumps DPB + NAL + slice + first-10-MB debug state per
sample (/root/reference/src/video/decoder.rs:128-140, with the Macroblock
Debug impl at macroblock.rs:274-429 making the dumps diffable).  This tool
is the equivalent here: it installs the decoder's per-picture debug
hook (dryv_tpu.decoder.PIC_DEBUG_HOOK / native/full._PIC_DEBUG_HOOK) and
writes one normalized text file per decoded picture, identical in format
across the scalar-Python and native-C++ paths so the first divergent line
between two runs localizes a desync to (picture, macroblock, field).

Usage:
    python tools/dump_mb_state.py CLIP [--path scalar|native]
        [--out DIR] [--mbs N] [--frames N]

CLIP is an Annex-B .264/.h264 elementary stream or an MP4/QuickTime file.
"""
from __future__ import annotations

import argparse
import os
import sys
import zlib

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def _crc(a) -> str:
    return f"{zlib.crc32(np.ascontiguousarray(a).tobytes()) & 0xFFFFFFFF:08x}"


def _crc_pix(a) -> str:
    """Plane checksum, dtype-normalized (scalar path uses int64 planes,
    native uint8; pixel values are identical)."""
    return _crc(np.asarray(a, dtype=np.uint8))


def _crc_coef(a) -> str:
    """Coefficient-block checksum, scan-order-insensitive: the scalar and
    native paths store identical values under different intra-block scan
    layouts, so each block's values are sorted before hashing.  Any
    entropy desync changes the value multiset and still trips this."""
    a = np.asarray(a, dtype=np.int32).reshape(-1, np.asarray(a).shape[-1])
    return _crc(np.sort(a, axis=-1))


def _fmt_mb_scalar(mb, addr: int) -> str:
    if mb is None:
        return f"mb {addr:5d} UNDECODED"
    return (f"mb {addr:5d} kind={int(mb.kind)} type={int(mb.mb_type_code)}"
            f" field={int(mb.field_flag)} t8={int(mb.transform8x8)}"
            f" cbp={int(mb.cbp):#04x} qp={int(mb.qp_y)}"
            f" i16={int(mb.i16_pred_mode)} cm={int(mb.chroma_mode)}"
            f" m4={''.join(str(int(v)) for v in mb.intra4x4_modes)}"
            f" ref={','.join(str(int(v)) for v in mb.ref_idx.ravel())}"
            f" mvd={_crc(mb.mvd.astype(np.int32))}"
            f" coef={_crc_coef(mb.luma_dc)}:{_crc_coef(mb.luma4)}:"
            f"{_crc_coef(mb.luma8)}:{_crc_coef(mb.chroma_dc)}:"
            f"{_crc_coef(mb.chroma_ac)}")


def _fmt_mb_native(out: dict, addr: int) -> str:
    return (f"mb {addr:5d} kind={int(out['kind'][addr])}"
            f" type={int(out['mb_type_code'][addr])}"
            f" field=0 t8={int(out['transform8'][addr])}"
            f" cbp={int(out['cbp'][addr]):#04x} qp={int(out['qp_y'][addr])}"
            f" i16={int(out['i16_mode'][addr])}"
            f" cm={int(out['chroma_mode'][addr])}"
            f" m4={''.join(str(int(v)) for v in out['modes4'][addr])}"
            f" ref={','.join(str(int(v)) for v in out['ref_idx'][addr].ravel())}"
            f" mvd={_crc(out['mvd'][addr].astype(np.int32))}"
            f" coef={_crc_coef(out['luma_dc'][addr])}:"
            f"{_crc_coef(out['luma4'][addr])}:{_crc_coef(out['luma8'][addr])}:"
            f"{_crc_coef(out['chroma_dc'][addr])}:"
            f"{_crc_coef(out['chroma_ac'][addr])}")


def make_hook(out_dir: str, n_mbs: int):
    os.makedirs(out_dir, exist_ok=True)

    def hook(path_name: str, pic_idx: int, st: dict):
        lines = [f"path={path_name} pic={pic_idx} poc={st['poc']}"]
        hs = st.get("headers") or []
        for i, h in enumerate(hs):
            lines.append(
                f"slice {i}: type={h.slice_type.name}"
                f" first_mb={h.first_mb_in_slice}"
                f" frame_num={h.frame_num} qp_delta={h.slice_qp_delta}"
                f" field={int(h.field_pic_flag)}"
                f" bottom={int(getattr(h, 'bottom_field_flag', 0) or 0)}")
        y, cb, cr = st["y"], st["cb"], st["cr"]
        lines.append(f"planes y={_crc_pix(y)} cb={_crc_pix(cb)} cr={_crc_pix(cr)}"
                     f" dims={y.shape[1]}x{y.shape[0]}")
        if "mbs" in st:  # scalar path
            mbs = st["mbs"]
            for a in range(min(n_mbs, len(mbs))):
                lines.append(_fmt_mb_scalar(mbs[a], a))
        else:  # native path: dense arrays in st["out"]
            out = st["out"]
            for a in range(min(n_mbs, len(out["kind"]))):
                lines.append(_fmt_mb_native(out, a))
        fp = os.path.join(out_dir, f"pic_{pic_idx:04d}.txt")
        with open(fp, "w") as f:
            f.write("\n".join(lines) + "\n")

    return hook


def load_stream(path: str) -> bytes:
    data = open(path, "rb").read()
    if data[4:8] in (b"ftyp", b"moov", b"mdat", b"wide", b"free"):
        from dryv_tpu.video import Video
        return Video.open(path).annexb_stream()
    return data


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("clip")
    ap.add_argument("--path", choices=("scalar", "native"),
                    default="scalar")
    ap.add_argument("--out", default="temp/mb_state")
    ap.add_argument("--mbs", type=int, default=16,
                    help="macroblocks dumped per picture (ref dumps 10)")
    ap.add_argument("--frames", type=int, default=0,
                    help="stop after N pictures (0 = all)")
    args = ap.parse_args(argv)

    stream = load_stream(args.clip)
    hook = make_hook(args.out, args.mbs)
    if args.path == "scalar":
        import dryv_tpu.decoder as dec
        dec.PIC_DEBUG_HOOK = hook
        try:
            frames = dec.decode_annexb_scalar(stream,
                                              max_frames=args.frames)
        finally:
            dec.PIC_DEBUG_HOOK = None
    else:
        import dryv_tpu.native.full as nf
        nf._PIC_DEBUG_HOOK = hook
        try:
            frames = nf.decode_annexb_native(stream,
                                             max_frames=args.frames)
        finally:
            nf._PIC_DEBUG_HOOK = None
    print(f"dumped {len(frames)} pictures to {args.out}/ "
          f"({args.path} path); diff two runs to bisect a desync")
    return 0


if __name__ == "__main__":
    sys.exit(main())
