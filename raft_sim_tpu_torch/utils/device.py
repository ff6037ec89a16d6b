"""Device selection for the port's entry points, and asynchronous copies to the host."""

from __future__ import annotations

import torch


def resolve(device="cuda") -> torch.device:
    """The torch.device an entry point runs on. The default is the card; with
    no card present that raises -- nothing drops to the CPU unless the caller
    asks for it (the tests pass device="cpu")."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but torch sees no CUDA device; "
            "pass device='cpu' to run on the CPU"
        )
    return dev


def _tree_map(fn, tree):
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_tree_map(fn, x) for x in tree))
    if isinstance(tree, list):
        return [_tree_map(fn, x) for x in tree]
    return fn(tree)


def to_host_async(tree):
    """Start copying a tree (NamedTuples and lists) of tensors to the host; returns
    (pending, event). CUDA leaves are copied into pinned host buffers behind
    the work already queued on the current stream, and `event` marks their
    end; CPU leaves need no copy (event None). `host_numpy(pending, event)`
    waits and hands back numpy leaves."""
    first = None

    def copy(x: torch.Tensor) -> torch.Tensor:
        nonlocal first
        if x.device.type != "cuda":
            return x
        first = x
        h = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
        h.copy_(x, non_blocking=True)
        return h

    pending = _tree_map(copy, tree)
    event = None
    if first is not None:
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(first.device))
    return pending, event


def host_numpy(pending, event):
    """The numpy tree of a `to_host_async` copy, once its event has passed."""
    if event is not None:
        event.synchronize()
    return _tree_map(lambda x: x.detach().numpy(), pending)
