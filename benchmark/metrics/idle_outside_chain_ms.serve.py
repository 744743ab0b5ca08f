"""Device-idle ms per profiled request in the gaps that begin while the host
is outside the program's ``cdae.cf.chain`` spans: the request's copy in,
its preparation and its answer's copy back."""

from benchmark import program


def read(trace):
    requests, chains = trace.counts.get("requests"), trace.spans("cdae.cf.chain")
    if not requests or not chains or not trace.kernels():
        return None
    return program.idle_ms(trace, lambda t: not program.covered(chains, t)) / requests
