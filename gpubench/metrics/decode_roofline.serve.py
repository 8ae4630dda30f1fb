"""Serving model step: the decode steps' least time (each step reads the
multiplied weights once and each alive row's live KV once, at the HBM
rate) over their time, in %."""

from gpubench import counts


def read(record):
    d = record.get("decode")
    if not d or not d["ms"]:
        return None
    a = record["arch"]
    nbytes = (d["steps"] * counts.decode_weight_bytes(a)
              + record["live_tokens"] * counts.kv_bytes_per_token(a))
    return 100.0 * counts.bound_s(0.0, nbytes)[0] / (d["ms"] / 1e3)
