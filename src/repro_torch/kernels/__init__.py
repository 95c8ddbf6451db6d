"""The port's kernels: hand-written CUDA for Hopper behind torch wrappers
that keep the reference launchers' signatures, each with its plain torch
version (taken for CPU tensors) and a launch counter."""
from repro_torch.kernels.conv2d import (  # noqa: F401
    conv2d_direct, conv2d_direct_ref, conv2d_im2col_gemm)
from repro_torch.kernels.grouped_matmul import (  # noqa: F401
    POOL_TAP_LIMIT, chained_layout, grouped_matmul_bwd,
    grouped_matmul_bwd_ref, grouped_matmul_chained,
    grouped_matmul_chained_ref, grouped_matmul_concat,
    grouped_matmul_concat_ref, grouped_matmul_pooled,
    grouped_matmul_pooled_ref, pool_cotangent_taps, pool_from_taps,
    pool_tap_views)
from repro_torch.kernels.runtime import (  # noqa: F401
    KERNEL_LAUNCHES, device_tables, reset_launch_counts)
