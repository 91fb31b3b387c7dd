"""Plain version of the consistent fixture package.

Drifted copy of kernel_pkg_ok: meta.py says TILE = 64; kernel.cu says 32."""


def toy_ref(x, wide: bool = False):
    return x + int(wide)
