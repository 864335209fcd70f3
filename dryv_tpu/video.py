"""Video facade (reference src/video/mod.rs Video::open).

Opens an MP4 file, locates the video track, exposes stream info (codec,
dimensions, duration, display matrix / rotation) and decodes frames
through the syntax + reconstruction pipeline.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .avc import split_avcc
from .container import MP4File
from .container.atoms import VIDEO_CODECS
from .decoder import DecodedFrame


@dataclass
class SeekPosition:
    """Seek grammar: '12s' | '1500ms' | '50%' | '1234ts' (reference
    video/mod.rs:131-160)."""
    kind: str = "ts"
    value: float = 0.0

    @classmethod
    def parse(cls, s: str) -> "SeekPosition":
        s = s.strip()
        for suffix, kind in (("ms", "ms"), ("s", "s"), ("%", "pct"),
                             ("ts", "ts")):
            if s.endswith(suffix):
                try:
                    return cls(kind, float(s[:-len(suffix)]))
                except ValueError:
                    break
        return cls("ts", 0.0)


class Video:
    def __init__(self, path):
        self.path = str(path)
        self.mp4 = MP4File(path)
        self.trak = self.mp4.video_track()
        if self.trak is None:
            raise ValueError("no video track")
        mdia = self.trak.mdia
        self.mdhd = mdia.mdhd
        self.minf = mdia.minf(self.mp4.f)
        self.stbl = self.minf.stbl
        entry = self.stbl.stsd.entries[0]
        self.fourcc = entry.fourcc
        self.codec = VIDEO_CODECS.get(entry.fourcc, "UNKNOWN")
        self.avc1 = entry.codec if entry.fourcc == b"avc1" else None

    @classmethod
    def open(cls, path) -> "Video":
        return cls(path)

    # -- info -----------------------------------------------------------
    @property
    def width(self) -> float:
        return self.trak.tkhd.width if self.trak.tkhd else 0

    @property
    def height(self) -> float:
        return self.trak.tkhd.height if self.trak.tkhd else 0

    @property
    def duration_seconds(self) -> float:
        if not self.mdhd or not self.mdhd.timescale:
            return 0.0
        return self.mdhd.duration / self.mdhd.timescale

    @property
    def rotation(self) -> float:
        tkhd = self.trak.tkhd
        return tkhd.matrix.rotation() if tkhd and tkhd.matrix else 0.0

    @property
    def meta_tags(self) -> dict:
        return self.mp4.moov.meta.tags if self.mp4.moov.meta else {}

    def info(self) -> dict:
        return {
            "codec": self.codec,
            "width": self.width,
            "height": self.height,
            "duration_s": self.duration_seconds,
            "rotation": self.rotation,
            "timescale": self.mdhd.timescale if self.mdhd else 0,
            "language": self.mdhd.language if self.mdhd else "und",
        }

    # -- decoding -------------------------------------------------------
    def annexb_stream(self) -> bytes:
        """Rebuild the elementary Annex-B stream: avcC parameter sets +
        every sample's NAL units in decode order."""
        if self.codec != "H264" or self.avc1 is None or self.avc1.avcc is None:
            raise NotImplementedError(f"codec {self.codec}")
        avcc = self.avc1.avcc
        from .avc import NalUnit, to_annexb

        nals = [NalUnit.parse(b) for b in avcc.sps_list + avcc.pps_list]
        for sample in self.mp4.iter_samples(self.stbl):
            nals.extend(split_avcc(sample, avcc.nal_length_size))
        return to_annexb(nals)

    def decode_frames(self, max_frames: int = 1, backend: str = "jax",
                      timers=None, interpret: bool = False):
        """Decode the first `max_frames` pictures to YUV, returned in
        display (POC) order.  Backends: 'jax' (device intra recon, native
        C++ host path for inter streams), 'native' (C++ entropy + recon +
        deblock), 'scalar' (Python refimpl).  The reference decodes
        exactly one intra frame (decoder.rs:88).  With `timers` (a
        utils.obs.StageTimers) the demux/entropy/pack/dispatch stages are
        accumulated for CLI --stats reporting.  interpret=True runs the
        device backends' Pallas kernel in interpret mode (no GPU)."""
        import contextlib
        import functools

        stage = (timers.stage if timers is not None
                 else lambda _name: contextlib.nullcontext())
        with stage("demux"):
            stream = self.annexb_stream()
        if backend == "jax" and timers is not None:
            from .gop_pipeline import decode_annexb_gop_pipelined
            frames = decode_annexb_gop_pipelined(stream, timers=timers,
                                                 interpret=interpret)
            if max_frames:
                frames = frames[:max_frames]
            return sorted(frames, key=lambda f: f.poc)
        if backend == "jax":
            from .pipeline import decode_annexb_fast
            fn = functools.partial(decode_annexb_fast, interpret=interpret)
        elif backend == "device-ipb":
            from .device_ipb import decode_annexb_device
            fn = functools.partial(decode_annexb_device, interpret=interpret)
        elif backend == "native":
            from .native.full import decode_annexb_native as fn
        else:
            from .decoder import decode_annexb_scalar as fn
        with stage("decode"):
            frames = fn(stream, max_frames=max_frames)
        return sorted(frames, key=lambda f: f.poc)

    def write_yuv(self, path, frame: DecodedFrame):
        """Planar YUV dump, Y then Cb then Cr (reference frame/mod.rs:48)."""
        with open(path, "wb") as f:
            f.write(frame.y.astype(np.uint8).tobytes())
            f.write(frame.cb.astype(np.uint8).tobytes())
            f.write(frame.cr.astype(np.uint8).tobytes())
