"""Device: the share of the profiled steps' wall time in which nothing
ran on the card, in %."""


def read(record):
    trace = record.get("trace")
    if not trace or not trace["busy_s"]:
        return None
    return 100.0 * (1.0 - trace["busy_s"] / trace["window_s"])
