"""Engine decode: ms a decode step over the window and its drain, from the
engine's `stats()["decode_by_batch"]` (each step timed to its `.cpu()`)."""


def read(record):
    d = record.get("decode")
    if not d or not d["steps"]:
        return None
    return d["ms"] / d["steps"]
