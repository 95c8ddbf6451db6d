"""PyTorch/CUDA port of the ``repro`` package for NVIDIA Hopper (H100).

The serving slice: GoogLeNet through the same execution plan as the JAX
reference (``core``), with the grouped, concat, pooled and chained
launches and the direct conv as hand-written CUDA kernels
(``kernels``, sources in ``csrc``), served by ``launch.serve``.
"""
