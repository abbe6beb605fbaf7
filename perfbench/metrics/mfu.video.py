"""Share of the chip's peak that the video window's head MLP matrix
operations use (bfloat16 at 989 TFLOP/s), in percent."""

from pbcore.readers import mfu_percent as read  # noqa: F401
