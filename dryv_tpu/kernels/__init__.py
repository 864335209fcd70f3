"""Device kernels (JAX/XLA and Pallas): the production reconstruction path.

Stage A (transform.py): inverse quant + inverse transforms, embarrassingly
parallel over every block of a frame.
Stage B (wavefront_kernel.py, reference wavefront.py): intra prediction +
reconstruction as an anti-diagonal macroblock wavefront (deps:
left/above/above-right, reference slice/mod.rs:576-613), all MBs on a
diagonal processed in parallel; deblock.py runs the in-loop filter as a
second wavefront.
Both stages are exact int32 arithmetic — bit-exact against refimpl.
"""
