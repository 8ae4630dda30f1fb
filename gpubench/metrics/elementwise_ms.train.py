"""Model and optimizer: device ms a profiled step of the kernels that are
neither products, flash nor NCCL (casts, norms, RoPE, adds, AdamW)."""


def read(record):
    trace = record.get("trace")
    if not trace or not trace["busy_s"]:
        return None
    return 1e3 * trace["groups_s"].get("elementwise", 0.0) / record["profile_steps"]
