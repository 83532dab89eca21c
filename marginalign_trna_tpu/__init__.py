"""marginalign_trna_tpu — a JAX reimplementation of the marginAlign-tRNA pipeline.

A from-scratch JAX/XLA framework providing the capabilities of the
reference marginAlign-tRNA toolchain (guide alignment, pair-HMM banded
forward-backward realignment, Baum-Welch EM training, posterior-decoding SNV
calling, and alignment QC statistics) on an accelerator (an NVIDIA H100):

- All DP inner loops are batched anti-diagonal wavefronts over device arrays
  (band rows x reads) compiled by XLA.
- Parallelism is data-parallel sharding over a ``jax.sharding.Mesh`` with
  ``psum``-merged expectation tensors, replacing the reference's jobTree
  process DAG + file-based reduction (reference: src/margin/utils.py:127,
  src/margin/marginCallerLib.py:171-187).
- The reference's C binaries (cPecanRealign, LAST/BWA/minimap2) are replaced
  by on-device DP and tracebacks plus a thin native (C++) host runtime for
  seed chaining and batch packing.
"""

__version__ = "0.1.0"
