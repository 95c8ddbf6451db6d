"""PyTorch/CUDA port of the ``repro`` package for NVIDIA Hopper (H100).

GoogLeNet served and trained through the same execution plans as the
JAX reference (``core``), and granite-moe-1b-a400m trained with its
experts on the grouped expert engine (``models.transformer``,
``models.moe``), with every kernel on those paths hand-written in CUDA
(``kernels``, sources in ``csrc``); entry points in ``launch``.
"""
