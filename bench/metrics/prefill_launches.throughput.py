"""Device kernel launches a request (its prefill and greedy token), from
the trace (``readers.launches_per_request``)."""
from bench import readers


def read(run):
    return readers.launches_per_request(run)
