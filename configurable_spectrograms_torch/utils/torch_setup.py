"""Device selection for the port (the counterpart of ``utils/jax_setup.py``).

``CST_TORCH_DEVICE`` names the device: ``cuda`` (the default) or ``cpu``.
Asking for ``cuda`` on a machine without a usable CUDA device raises: the
port never moves work to the CPU behind the caller's back.  A CUDA device
always carries its index: ``cuda:{LOCAL_RANK}`` in a rank that
:func:`..parallel.mesh.init_distributed` bound to its card, ``cuda:0``
otherwise.  (CUDA's current device belongs to each host thread, and the
batch driver's worker threads start on device 0, so an index-less
``cuda`` would name another card in a worker than in the rank's main
thread, and give one card two keys in per-device caches.)  TF32 is turned
off for matmuls and cuDNN so float32 stays float32 (the JAX reference
computes in full float32).
"""

from __future__ import annotations

import os

import torch

_CHOICES = ("cuda", "cpu")


def get_device() -> torch.device:
    """The torch device named by ``CST_TORCH_DEVICE`` (default ``cuda``), with its index on a card."""
    name = os.environ.get("CST_TORCH_DEVICE", "cuda").strip().lower()
    if name not in _CHOICES:
        raise ValueError(f"CST_TORCH_DEVICE must be one of {_CHOICES}, got {name!r}")
    if name == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CST_TORCH_DEVICE=cuda but torch.cuda.is_available() is False")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if name == "cpu":
        return torch.device("cpu")
    from configurable_spectrograms_torch.parallel.mesh import local_device_index

    index = local_device_index()
    return torch.device("cuda", 0 if index is None else index)
