#!/usr/bin/env python3
"""Full conformance sweep: every fixture through every decode path.

Usage: python tools/run_full_conformance.py [--interpret]
(--interpret runs the device wavefront kernel in Pallas interpret mode,
for machines without a GPU)."""
import functools
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from dryv_tpu.decoder import decode_annexb_scalar
from dryv_tpu.native.full import decode_annexb_native
from dryv_tpu.pipeline import decode_annexb_fast, decode_annexb_tpu
from dryv_tpu.testing.fixtures import all_fixture_names, get_fixture


def main(argv=None):
    interpret = "--interpret" in (sys.argv[1:] if argv is None else argv)
    fails = 0
    for name in all_fixture_names():
        stream, (gy, gcb, gcr), _, _ = get_fixture(name)
        for label, fn in (("scalar", decode_annexb_scalar),
                          ("native", decode_annexb_native),
                          ("jax", functools.partial(decode_annexb_tpu,
                                                    interpret=interpret)),
                          ("fast", functools.partial(decode_annexb_fast,
                                                     interpret=interpret))):
            f = fn(stream)[0]
            if f.cb is None:
                # monochrome: libavcodec synthesizes constant-128 chroma
                ok = (np.array_equal(f.y, gy)
                      and (gcb is None or (gcb == 128).all()))
            else:
                ok = (np.array_equal(f.y, gy) and np.array_equal(f.cb, gcb)
                      and np.array_equal(f.cr, gcr))
            print(f"{name:16s} {label:6s} bit-exact: {ok}")
            fails += 0 if ok else 1
    print("FAILURES:", fails)
    return 1 if fails else 0


if __name__ == "__main__":
    raise SystemExit(main())
