"""Device time under the program's ``gf::field`` span per frame."""

from pbcore.readers import per_unit_ms


def read(ctx):
    return per_unit_ms(ctx["trace"].span_device_s("gf::field"), ctx, "frames")
