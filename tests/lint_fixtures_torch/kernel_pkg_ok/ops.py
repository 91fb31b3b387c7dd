"""Wrappers of the consistent fixture package (parsed, never imported)."""
import torch

from repro_torch.kernels import _build

from .ref import toy_ref


def _launch(x, wide):
    n = x.shape[0]
    dev = x.device
    _build.check_tensor(x, "x", torch.int32, (n,), dev)
    y = torch.empty((n,), dtype=torch.int32, device=dev)
    _build.launch("kernel_pkg_ok", "toy_launch", dev, x, y, n, int(wide))
    return y


def toy(x, wide: bool = False):
    if x.is_cuda:
        return _launch(x, wide)
    return toy_ref(x, wide=wide)
