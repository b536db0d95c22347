"""geossl_tpu_torch — the PyTorch/CUDA port of geossl_tpu for NVIDIA Hopper.

The JAX package ``geossl_tpu`` stays the reference; this package imports
``torch`` and numpy only. Its kernels are hand-written CUDA C++
(``ops/csrc``), built with ``nvcc`` for ``sm_90a`` on first use. Tensors on
the CPU take each kernel's plain PyTorch version; tensors on a CUDA device
launch the kernel. Entry points run on ``cuda`` unless given ``device="cpu"``.
"""
