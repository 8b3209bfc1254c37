"""setup_s: process start to the first timed surface (host clock): the
imports, the inputs from the seed, the program, its kernels' build or
load, and the warm-up surfaces."""


def read(ctx):
    return ctx.setup_s
