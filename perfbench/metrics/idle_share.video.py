"""Device idle share of the video window: 1 - union of device-busy
intervals / wall, from the profiler's records."""

from pbcore.readers import idle_share as read  # noqa: F401
