"""Wrappers of the consistent fixture package (parsed, never imported).

Drifted copy of kernel_pkg_ok: ops.py launches toy_lanch, which no extern "C" defines."""
import torch

from repro_torch.kernels import _build

from .ref import toy_ref


def _launch(x, wide):
    n = x.shape[0]
    dev = x.device
    _build.check_tensor(x, "x", torch.int32, (n,), dev)
    y = torch.empty((n,), dtype=torch.int32, device=dev)
    _build.launch(  # LINT-EXPECT: kernel-shape
        "kernel_unknown_symbol", "toy_lanch", dev, x, y, n, int(wide))
    return y


def toy(x, wide: bool = False):
    if x.is_cuda:
        return _launch(x, wide)
    return toy_ref(x, wide=wide)
