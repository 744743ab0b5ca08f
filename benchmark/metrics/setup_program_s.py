"""Host seconds of the program's set-up spans, ``cdae.setup.*``, every
occurrence: building the model, the train state, the step and the chains,
preparing the attention forward and building the kernels. Self seconds are
summed, so a build inside ``prepare_forward`` counts once."""

from benchmark import program


def read(trace):
    snap = program.snapshot()
    setup = [s for k, s in (snap or {}).get("spans", {}).items() if k.startswith("cdae.setup.")]
    return sum(s["self_s"] for s in setup) if setup else None
