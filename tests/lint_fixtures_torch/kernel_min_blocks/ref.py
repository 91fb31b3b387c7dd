"""Plain version of the consistent fixture package.

Drifted copy of kernel_pkg_ok: 8 blocks an SM of 33,056 static bytes each."""


def toy_ref(x, wide: bool = False):
    return x + int(wide)
