"""Multi-chip scaling (SURVEY.md §2.10): mesh construction, frame-parallel
GOP decode (dp axis), and band-parallel wavefront reconstruction with
halo exchange of intra-boundary pixel rows (sp axis).

The reference is strictly sequential (zero parallelism, no comm backend);
these axes exploit the bitstream's latent parallelism: frames/GOPs are
independent, slices are independently entropy-decodable, and the MB
wavefront admits band sharding with one boundary pixel-row exchanged per
diagonal step (ring ppermute).
"""
from .mesh import make_mesh
from .gop import decode_gop_sharded, make_gop_recon_fn
from .bands import make_banded_wavefront_fn

__all__ = ["make_mesh", "decode_gop_sharded", "make_gop_recon_fn",
           "make_banded_wavefront_fn"]
