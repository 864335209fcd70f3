"""Interpret mode is only ever chosen by a caller: every factory that
builds the wavefront kernel compiles it for the device unless passed
interpret=True, and nothing in the package branches on the backend."""
import ast
import pathlib

import jax
import jax.numpy as jnp
import pytest

PKG = pathlib.Path(__file__).resolve().parent.parent / "dryv_tpu"


def _pallas_interpret_flags(jaxpr):
    """interpret params of every pallas_call, sub-jaxprs included."""
    out = []
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "pallas_call":
            out.append(eqn.params["interpret"])
        for v in eqn.params.values():
            for sub in (v if isinstance(v, (list, tuple)) else [v]):
                sub = getattr(sub, "jaxpr", sub)
                if isinstance(sub, jax.extend.core.Jaxpr):
                    out += _pallas_interpret_flags(sub)
    return out


@pytest.fixture(scope="module")
def fixture_syntax():
    from dryv_tpu.avc import split_annexb
    from dryv_tpu.coeffs import pack_frame
    from dryv_tpu.decoder import SyntaxDecoder, group_access_units
    from dryv_tpu.testing.fixtures import get_fixture

    stream, _, _, _ = get_fixture("slices_qp28")
    sd = SyntaxDecoder()
    rest = sd.feed_parameter_sets(list(split_annexb(stream)))
    sps, pps, mbs, _ = sd.decode_picture_syntax(group_access_units(rest)[0])
    return pack_frame(mbs, sps, pps)


def _trace(factory, fs, **kw):
    from dryv_tpu.gop_pipeline import make_gop_pipeline, stack_gop_compact
    from dryv_tpu.kernels.transform import LS4_FLAT, LS8_FLAT
    from dryv_tpu.pipeline import SYNTAX_KEYS, _build

    ls = [jnp.asarray(LS4_FLAT)] * 3 + [jnp.asarray(LS8_FLAT)]
    if factory == "gop_pipeline":
        fn = make_gop_pipeline(fs.mb_w, fs.mb_h, False, **kw)
        return jax.make_jaxpr(fn)(stack_gop_compact([fs] * 2), *ls)
    if factory == "per_picture":
        fn = _build(fs.mb_w, fs.mb_h, False, **kw)
        s = {k: jnp.asarray(getattr(fs, k)) for k in SYNTAX_KEYS}
        return jax.make_jaxpr(fn)(s, *ls)
    if factory == "gop_sharded":
        from dryv_tpu.parallel import make_mesh
        from dryv_tpu.parallel.gop import make_gop_recon_fn, stack_frames
        fn = make_gop_recon_fn(make_mesh({"gop": 2}), fs.mb_w, fs.mb_h,
                               **kw)
        return jax.make_jaxpr(fn)(stack_frames([fs] * 2))
    from dryv_tpu.kernels.wavefront_kernel import (
        make_gop_wavefront_kernel_fn)
    n = fs.mb_w * fs.mb_h
    s = {k: jnp.asarray(getattr(fs, k))[None] for k in
         ("kind", "i16_mode", "chroma_mode", "modes4", "modes8",
          "avail_a", "avail_b", "avail_c", "avail_d")}
    fn = make_gop_wavefront_kernel_fn(fs.mb_w, fs.mb_h, **kw)
    return jax.make_jaxpr(fn)(s, jnp.zeros((1, n, 16, 16), jnp.int32),
                              jnp.zeros((1, n, 2, 8, 8), jnp.int32))


@pytest.mark.parametrize("factory", ["kernel", "gop_pipeline",
                                     "per_picture", "gop_sharded"])
@pytest.mark.parametrize("passed", [None, True])
def test_factories_never_choose_interpret(fixture_syntax, factory, passed):
    kw = {} if passed is None else {"interpret": passed}
    flags = _pallas_interpret_flags(_trace(factory, fixture_syntax,
                                           **kw).jaxpr)
    assert flags, "no pallas_call traced"
    assert all(f is bool(passed) for f in flags), flags


def test_package_never_picks_interpret_or_branches_on_backend():
    for path in PKG.rglob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.Attribute):
                assert node.attr != "default_backend", path
            if isinstance(node, ast.keyword) and node.arg == "interpret":
                # passing interpret through is fine; a literal True is not
                assert not (isinstance(node.value, ast.Constant)
                            and node.value.value is True), path
            if isinstance(node, (ast.FunctionDef, ast.Lambda)):
                args = node.args
                for a, d in zip(args.args[::-1], args.defaults[::-1]):
                    if a.arg == "interpret":
                        assert isinstance(d, ast.Constant) and \
                            d.value is False, path
