"""Plain version of the consistent fixture package.

Drifted copy of kernel_pkg_ok: the c_args drift of kernel_c_args, allowed inline."""


def toy_ref(x, wide: bool = False):
    return x + int(wide)
