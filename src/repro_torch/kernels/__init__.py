"""Hand-written CUDA kernels for Hopper (``csrc/``), each beside its plain
PyTorch version: ``pairwise_dist`` (the harvest's f32 candidate filter) and
``gf2`` (the packed reduction's find-low, parallel XOR and serial phase).
Built with nvcc at first use and loaded with ctypes (``_build``)."""
