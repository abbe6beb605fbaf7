"""The 95th percentile of every viewer frame's latency in the window (the
call to the uint8 frame on the host), in ms: the tail beside
``live_frame_ms``. Read in the traced run, whose profiler adds to each
frame."""

from pbcore.readers import p95_ms


def read(ctx):
    lat = ctx["out"].get("latencies_s")
    return p95_ms(lat) if lat else None
