"""repro_torch: the PyTorch/CUDA port of the Dory pipeline.

A package beside the JAX reference ``repro`` (which it never imports):
``compute_ph`` runs on an NVIDIA card by default, with hand-written CUDA
kernels for the tiled harvest's f32 candidate filter and the packed GF(2)
reduction, and on the CPU (``device="cpu"``) through their plain PyTorch
versions.  Filtrations and diagrams are bit-identical to the reference.
"""
from .core import PHResult, compute_ph

__version__ = "0.1.0"

__all__ = ["PHResult", "compute_ph"]
