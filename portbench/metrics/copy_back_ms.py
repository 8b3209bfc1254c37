"""copy_back_ms: the device time of the device-to-host copies that start
inside the program's ``is3d2::copy_back`` span (the spectra's ``.cpu()``),
the mean over the window's surfaces."""

from portbench.harness import program_spans


def read(ctx):
    t = ctx.trace
    if t is None or not t.has_device:
        return None
    copies = [(a, b) for a, b, name, cat in t.device
              if cat == "gpu_memcpy" and "DtoH" in name]

    def device_us(s0, s1):
        return sum(b - a for a, b in copies if s0 <= a < s1)

    return program_spans.mean_ms(ctx, ("copy_back",), device_us)
