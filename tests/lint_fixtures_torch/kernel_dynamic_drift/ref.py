"""Plain version of the consistent fixture package.

Drifted copy of kernel_pkg_ok: meta.py declares 32,768 bytes of dynamic
shared memory, the launch requests 65,536."""


def toy_ref(x, wide: bool = False):
    return x + int(wide)
