"""95th percentile, over every request completed in the window, of the
time from its dispatch to its first token on the host (nearest rank)."""
from bench import readers, yardstick


def read(run):
    v = readers.ttft_ms(run)
    return yardstick.percentile(v, 95) if v else None
