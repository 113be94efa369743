"""Set-up: process start to the window's opening (imports, weights,
kernel builds, one prefill of every shape the traffic can send)."""


def read(run):
    return run.setup_s
