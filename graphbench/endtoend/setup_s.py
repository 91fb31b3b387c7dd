"""setup_s: from the process's start to the window's first round: the
imports, loading the kernel libraries (building them, in a checkout's
first run), generating the graph and the traffic, building the store on
the device, and the warm rounds."""


def read(ctx):
    return ctx.setup_s
