"""Process start to the first timed frame: the world made, the program's
tables built, its kernels loaded or built, the mix's frames warmed."""


def read(ctx):
    return ctx.setup_s
