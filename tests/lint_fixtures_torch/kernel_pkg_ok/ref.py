"""Plain version of the consistent fixture package."""


def toy_ref(x, wide: bool = False):
    return x + int(wide)
