"""Share of the chip's peak that the training window's MLP matrix
operations use (the head x3 where trained, the frozen head x1, the torso
x3; bfloat16 parts at 989 TFLOP/s, float32 at 67), in percent."""

from pbcore.readers import mfu_percent as read  # noqa: F401
