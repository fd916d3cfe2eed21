"""blp_tpu_torch — the BLP link-prediction framework in PyTorch and CUDA, for
one NVIDIA H100.

A port of the JAX package `blp_tpu`, which stays beside it as the reference:
module names follow it, parameters keep its layout at the public boundary
((in, out) matrices used as ``x @ W``, stacked ``(L, ...)`` layer leaves),
and the tests hold each module against its counterpart. This package imports
neither JAX nor `blp_tpu`; the host code it needs is copied here. The TPU
package's Pallas kernels become hand-written CUDA kernels under ``csrc/``,
built with ``nvcc`` at first use (``ops/_cuda.py``). Entry points run on
``cuda`` unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
