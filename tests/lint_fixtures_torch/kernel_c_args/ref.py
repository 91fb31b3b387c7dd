"""Plain version of the consistent fixture package.

Drifted copy of kernel_pkg_ok: ops.py passes no `wide` flag; toy_launch takes 5 C parameters."""


def toy_ref(x, wide: bool = False):
    return x + int(wide)
