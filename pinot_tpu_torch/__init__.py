"""pinot_tpu_torch — the PyTorch/CUDA port of pinot_tpu for one NVIDIA H100.

The JAX package ``pinot_tpu`` stays beside it as the reference; this package
imports nothing of it and no JAX.  Its layout mirrors the reference module
for module (``spi/``, ``segment/``, ``indexes/``, ``sql/``, ``query/``,
``ops/``), and its one hand-written kernel, ``ops/csrc/fused_scan.cu``,
replaces the reference's Pallas scan ``ops/pallas_scan.py``.

Device arrays are ``torch`` tensors.  Every entry point takes ``device=``;
``None`` means CUDA and raises where there is none (``device.py``), and
``"cpu"`` runs the kernels' plain PyTorch versions, as the tests do.
"""

__version__ = "0.1.0"
