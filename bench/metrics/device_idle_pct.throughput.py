"""Share of the device-only traced stretch with no device operation
running, a union of intervals (``readers.idle_pct``)."""
from bench import readers


def read(run):
    return readers.idle_pct(run)
