"""Plain version of the consistent fixture package.

Drifted copy of kernel_pkg_ok: ops.py allocates y as float32; meta.py says int32."""


def toy_ref(x, wide: bool = False):
    return x + int(wide)
