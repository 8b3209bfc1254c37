"""The run's device, and host-to-device copies that do not hold up the
device's queue.

``run_device`` picks the device of an entry point: CUDA unless the caller
asks for another, and an error where torch sees no GPU rather than a
silent fall back to the CPU.

A plain copy of host memory to a CUDA device (``torch.as_tensor(a,
device="cuda")``, ``.to("cuda")``) returns only after every kernel already
queued on the current stream has finished.  ``to_device`` stages the data
in pinned (page-locked) host memory and copies it asynchronously instead:
the host goes on at once, and the copy runs in stream order, after the
kernels queued before it and before those queued after it.  A
multi-surface run (core/ensemble.py) prepares surface k+1 this way while
surface k's kernel runs.  The values are those of the plain copy.
"""

from __future__ import annotations

import torch


def run_device(device=None) -> torch.device:
    """``device`` as a torch.device, "cuda" for None; raises where torch
    sees no CUDA device and the caller did not ask for the CPU.  A CUDA
    device without an index is named by the current one's ("cuda" means
    whichever device is current when a tensor is made; a run over several
    devices must name each)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("torch sees no CUDA device; pass device='cpu' "
                           "(--device cpu) to run on the CPU")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def to_device(a, device, dtype: torch.dtype = torch.float64) -> torch.Tensor:
    """``a`` (array, scalar or tensor) as a ``dtype`` tensor on ``device``.
    Host data bound for a CUDA device goes through pinned memory without
    blocking; anything else is ``torch.as_tensor``'s (on the CPU it may
    share ``a``'s memory)."""
    dev = torch.device(device)
    t = torch.as_tensor(a, dtype=dtype)
    if dev.type != "cuda" or t.device.type == "cuda":
        return t.to(dev)
    return t.pin_memory().to(dev, non_blocking=True)
