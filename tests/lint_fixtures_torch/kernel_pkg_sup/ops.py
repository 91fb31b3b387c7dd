"""Wrappers of the consistent fixture package (parsed, never imported).

Drifted copy of kernel_pkg_ok: the c_args drift of kernel_c_args, allowed inline."""
import torch

from repro_torch.kernels import _build

from .ref import toy_ref


def _launch(x, wide):
    n = x.shape[0]
    dev = x.device
    _build.check_tensor(x, "x", torch.int32, (n,), dev)
    y = torch.empty((n,), dtype=torch.int32, device=dev)
    _build.launch("kernel_pkg_sup", "toy_launch", dev, x, y, n)  # repro-torch-lint: allow(kernel-shape)
    return y


def toy(x, wide: bool = False):
    if x.is_cuda:
        return _launch(x, wide)
    return toy_ref(x, wide=wide)
