"""Plain version of the consistent fixture package.

Drifted copy of kernel_pkg_ok: 4 blocks an SM of 4,384 static and 65,536
dynamic bytes each."""


def toy_ref(x, wide: bool = False):
    return x + int(wide)
