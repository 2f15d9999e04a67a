"""What the wrappers of the split-KV attention kernels share: K1
(``spec_verify_attn.py``) and K2/K3 (``paged_verify_attn.py``) both pick a
split count from the card's SM count, copy q/k/v 16 bytes at a time, call
a C entry point on the current stream and issue one or two device kernels
a call.  How a split call is launched and counted is decided here once.
"""
from __future__ import annotations

from typing import Callable

import torch

_SMS: dict = {}          # SM count by device index, read once: every call needs it


def sm_count(dev: torch.device) -> int:
    """The SM count of ``dev``, which the split rules read."""
    n = _SMS.get(dev.index)
    if n is None:
        n = _SMS[dev.index] = torch.cuda.get_device_properties(dev).multi_processor_count
    return n


def on_one_cuda_device(tensors, dev: torch.device) -> bool:
    return dev.type == "cuda" and all(t.device == dev for t in tensors)


def aligned16(t: torch.Tensor) -> bool:
    """Whether ``t`` starts, and has its two outer strides (where the size
    is not 1), at multiples of 16 bytes, as 16-byte copies of its rows
    need."""
    es = t.element_size()
    return t.data_ptr() % 16 == 0 and all(
        t.shape[d] == 1 or (t.stride(d) * es) % 16 == 0 for d in (0, 1))


def invoke(entry: Callable, dev: torch.device, *args) -> int:
    """Call the C function that ``entry()`` returns with ``args`` and
    ``dev``'s current stream; its cudaError_t."""
    with torch.cuda.device(dev):
        return entry()(*args, torch.cuda.current_stream(dev).cuda_stream)


def device_kernels(splits: int) -> int:
    """Device kernels one call issues: the split kernel, and the combine
    when the key range is split."""
    return 1 if splits == 1 else 2
