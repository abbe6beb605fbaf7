"""Host time in ``RADNeRFInfer.prepare`` (the benchmark's ``pb::prepare``
span: capacity probe, k-DOP, occupancy view, grid views) per frame."""

from pbcore.readers import per_unit_ms


def read(ctx):
    return per_unit_ms(ctx["trace"].host_span_s("pb::prepare"), ctx, "frames")
