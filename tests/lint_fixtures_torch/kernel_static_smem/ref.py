"""Plain version of the consistent fixture package.

Drifted copy of kernel_pkg_ok: buf grows to int32[32][400], 51,200 bytes of static shared memory."""


def toy_ref(x, wide: bool = False):
    return x + int(wide)
