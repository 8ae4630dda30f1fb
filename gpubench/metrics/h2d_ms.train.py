"""Input pipeline: host-to-device dispatch ms a timed step, from step
telemetry's `h2d_ms` phase (`prefetch_to_device`'s pin and copy)."""


def read(record):
    w = record.get("window")
    if not w or not w["steps"]:
        return None
    return w["h2d_ms"] / w["steps"]
