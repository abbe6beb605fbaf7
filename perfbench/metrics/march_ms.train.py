"""Device time under the program's ``gf::march`` span per step: the
lattice march (head) or the walk over the frozen head (torso)."""

from pbcore.readers import per_unit_ms


def read(ctx):
    return per_unit_ms(ctx["trace"].span_device_s("gf::march"), ctx, "steps")
