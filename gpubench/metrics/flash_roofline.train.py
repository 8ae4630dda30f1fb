"""Attention kernels: the flash launches' least time (each forward launch
and each backward op at the dense bf16 peak or HBM rate, over the causal
pairs the batch needs) over the flash kernels' device time, in %."""

from gpubench import counts


def read(record):
    trace, launches = record.get("trace"), record.get("launches")
    if not trace or not launches:
        return None
    device_s = trace["groups_s"].get("flash", 0.0)
    if not device_s:
        return None
    a = record["arch"]
    shape = (record["batch"], a["heads"], record["seq"], record["seq"], a["head_dim"])
    fwd = counts.bound_s(counts.flash_fwd_flops(*shape),
                         counts.flash_io_bytes(*shape))[0]
    bwd = counts.bound_s(counts.flash_bwd_flops(*shape),
                         counts.flash_io_bytes(*shape, backward=True))[0]
    bound = launches.get("flash_fwd", 0) * fwd + launches.get("flash_bwd", 0) * bwd
    return 100.0 * bound / device_s
