"""Plain version of the consistent fixture package.

Drifted copy of kernel_pkg_ok: ops.py launches toy_lanch, which no extern "C" defines."""


def toy_ref(x, wide: bool = False):
    return x + int(wide)
