"""Engine prefill: prompt tokens a second of prefill chunks (padded chunk
tokens over the chunks' synchronised time), from the engine's stats."""


def read(record):
    p = record.get("prefill")
    if not p or not p["ms"]:
        return None
    return p["tokens"] / (p["ms"] / 1e3)
