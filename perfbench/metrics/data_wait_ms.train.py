"""Host time the step waits for its batch (the benchmark's
``pb::data_wait`` span around ``next(batches)``) per step."""

from pbcore.readers import per_unit_ms


def read(ctx):
    return per_unit_ms(ctx["trace"].host_span_s("pb::data_wait"), ctx, "steps")
