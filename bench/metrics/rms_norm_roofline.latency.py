"""The RMSNorm kernel's share of its roofline (``rms_norm_kernel.read``):
Σ bound over Σ device time of its launches in the device-only traced
requests, bound = (rows·d·(2 + 2) + 2·d) / 3.35 TB/s a call; silent
without the kernel, or with more than 2·L + 1 launches a traced prefill or
fewer than 95 % of them (the share found scales the bound)."""
from bench import rms_norm_kernel


def read(run):
    return rms_norm_kernel.read(run)
