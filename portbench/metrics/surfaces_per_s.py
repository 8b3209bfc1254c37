"""surfaces_per_s: surfaces whose spectra reached the host, over the time
from the first surface's start to the last one's end (host clock)."""


def read(ctx):
    r = ctx.records
    return len(r) / (r[-1].end - r[0].start)
