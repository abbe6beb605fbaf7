"""Host time in ``RealtimeRenderer.inputs`` (the benchmark's ``pb::inputs``
span: the camera's rays, the dataset item, the background, the screen
coordinates) per frame."""

from pbcore.readers import per_unit_ms


def read(ctx):
    return per_unit_ms(ctx["trace"].host_span_s("pb::inputs"), ctx, "frames")
