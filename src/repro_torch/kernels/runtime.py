"""What every kernel wrapper shares: launch counters, the device-resident
per-tile tables, and the checks a wrapper makes before it launches.

A wrapper takes its kernel's plain PyTorch version for tensors on the
CPU and launches the CUDA kernel for tensors on a CUDA device; there is
no other path and no fallback between the two.
"""
from __future__ import annotations

import torch

#: CUDA kernel launches by wrapper name: each wrapper adds one where it
#: launches its kernel, and nowhere else (the plain CPU path counts
#: nothing).
KERNEL_LAUNCHES: dict[str, int] = {
    "grouped_matmul_concat": 0,
    "grouped_matmul_pooled": 0,
    "grouped_matmul_chained": 0,
    "conv2d_direct": 0,
    "matmul": 0,
    "grouped_matmul_bwd": 0,
    "grouped_matmul_experts": 0,
    "grouped_matmul_experts_bwd": 0,
    "branch_matmul": 0,
    "ssd_chunked": 0,
    "flash_attention": 0,
    "fused_gemm_reduce": 0,
    "matmul_ksplit": 0,
    "grouped_matmul_dw": 0,
}

#: CUDA kernels launched by the expert wrappers, whose one call (counted
#: once in KERNEL_LAUNCHES, like the reference's one ``pallas_call``) runs
#: two stages here.
CUDA_LAUNCHES: dict[str, int] = {"grouped_matmul_experts": 0,
                                 "grouped_matmul_experts_bwd": 0}

#: Calls of the chained wrapper that launched its kernel: one launch each,
#: as the reference runs each such call (so this equals
#: ``KERNEL_LAUNCHES["grouped_matmul_chained"]``).
CHAINED_CALLS = 0


def reset_launch_counts() -> None:
    global CHAINED_CALLS
    for k in KERNEL_LAUNCHES:
        KERNEL_LAUNCHES[k] = 0
    for k in CUDA_LAUNCHES:
        CUDA_LAUNCHES[k] = 0
    CHAINED_CALLS = 0


def count_launch(name: str) -> None:
    KERNEL_LAUNCHES[name] += 1


class DeviceTables:
    """Per-tile int32 tables on the device, built once per (launch shape,
    device) and reused by identity afterwards; ``builds`` counts every
    table ever built, the instrument for "a warm dispatch rebuilds
    nothing" (``core.plan_cache``)."""

    def __init__(self):
        self._tabs: dict = {}
        self.builds = 0

    def get(self, key, build, device) -> torch.Tensor:
        k = (key, str(device))
        t = self._tabs.get(k)
        if t is None:
            t = torch.tensor(build(), dtype=torch.int32, device=device)
            self._tabs[k] = t
            self.builds += 1
        return t

    def clear(self) -> None:
        self._tabs.clear()

    def __len__(self):
        return len(self._tabs)


device_tables = DeviceTables()


_SPLIT_COUNTERS: dict = {}


def split_counters(device: torch.device, stream: int,
                   n: int) -> torch.Tensor:
    """At least ``n`` int32 arrival counters on ``device``, all 0: one per
    output tile of a split-K launch (K1-K5, K9), or a chained
    launch's ticket, finish and done counters (K6).  One buffer per (device,
    stream), so launches on two streams at once never share a counter;
    it is zeroed on the current stream, the one that uses it, and reused:
    the kernel's last CTA of each tile sets its counter back to 0.  Grown
    by allocating a new zeroed buffer."""
    key = (device.index, stream)
    buf = _SPLIT_COUNTERS.get(key)
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, 1024), dtype=torch.int32, device=device)
        _SPLIT_COUNTERS[key] = buf
    return buf


_SM_COUNT: dict = {}


def sm_count(device: torch.device) -> int:
    """The card's streaming multiprocessors (132 on an H100 SXM)."""
    key = str(device)
    n = _SM_COUNT.get(key)
    if n is None:
        n = torch.cuda.get_device_properties(device).multi_processor_count
        _SM_COUNT[key] = n
    return n


def kernel_device(name: str, tensors) -> torch.device:
    """The one device all of a call's tensors lie on; raises on a mix, on
    a device that is neither the CPU nor CUDA, or on a dtype other than
    float32 (the serving and training paths are f32, and so is every
    kernel)."""
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"{name}: tensors on several devices {devs}")
    dev = devs.pop()
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: no kernel for device {dev}")
    for t in tensors:
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: kernels take float32, got {t.dtype}")
    return dev


def require_contiguous(name: str, tensors) -> None:
    for t in tensors:
        if not t.is_contiguous():
            raise ValueError(f"{name}: the kernel takes contiguous tensors, "
                             f"got shape {tuple(t.shape)} strides "
                             f"{t.stride()}")


def stream_handle(device: torch.device) -> int:
    """The raw ``cudaStream_t`` of the current stream on ``device``
    (torch's raw-stream query: no ``torch.cuda.Stream`` is built)."""
    index = device.index
    return torch._C._cuda_getCurrentRawStream(
        torch.cuda.current_device() if index is None else index)


def row_limit(name: str, m: int, m_valid) -> int:
    """Rows below which a launch computes (ragged M: the first ``m_valid``
    rows are real and the rest store zeros)."""
    if m_valid is None:
        return m
    mv = int(m_valid)
    if not 0 <= mv <= m:
        raise ValueError(f"{name}: m_valid={mv} outside [0, {m}]")
    return mv


def resolve_device(device=None) -> torch.device:
    """An entry point's device: ``None`` means the CUDA card.  Raises when
    the card is asked for and there is none — the port never carries on
    quietly on the CPU; pass ``device="cpu"`` for the plain versions."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run the plain torch versions on the CPU")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev
