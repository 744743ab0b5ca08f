"""Host ms from a UNet call's entry to its return: the program's span
``cdae.unet.denoise``, mean of its warm occurrences. The inside twin of
``host_ms_per_unet_call.serve``, which times the same calls from outside."""

from benchmark import program


def read(trace):
    return program.warm_ms(program.snapshot(), "cdae.unet.denoise")
