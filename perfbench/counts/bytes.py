"""Bytes that K1 and K8 calls must move, from their logical shapes: each
input read once, each output written once, whatever the kernel reads again.

- K1 (row scatter-add, ``[M, W]`` updates into ``[R, W]`` float32 sums):
  the ``M`` int32 rows and the updates read, the sums written.
- K8 (row gather of ``M`` rows of a ``[R, W]`` table into ``[M, W]``
  float32): the ``M`` int32 indices read, at most ``min(M, R)`` distinct
  table rows read, the rows written.
"""

#: H100 SXM HBM3, NVIDIA's data sheet
PEAK_BYTES_S = 3.35e12


def k1_bytes(M: int, W: int, R: int, itemsize: int, **_) -> int:
    return M * 4 + M * W * itemsize + R * W * 4


def k8_bytes(M: int, W: int, R: int, itemsize: int, **_) -> int:
    return M * 4 + min(M, R) * W * itemsize + M * W * 4


def bound_s(calls: list, which: str) -> float:
    """Seconds the HBM bound allows for the ``which`` (``k1``/``k8``) calls."""
    fn = k1_bytes if which == "k1" else k8_bytes
    return sum(fn(**shape) for kind, shape in calls if kind == which) / PEAK_BYTES_S
