"""Plain version of the consistent fixture package.

Drifted copy of kernel_pkg_ok: toy_ref takes n as a second operand and no `wide` option."""


def toy_ref(x, n):  # LINT-EXPECT: kernel-shape
    return x[:n]
