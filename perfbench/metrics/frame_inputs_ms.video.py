"""Host time of a frame's inputs (the program's ``gf::frame_inputs`` span in
``RADNeRFInfer.render_frame``: the dataset item, the condition window, the
copies of rays, background and pose to the device) per frame."""

from pbcore.readers import per_unit_ms


def read(ctx):
    return per_unit_ms(ctx["trace"].host_span_s("gf::frame_inputs"), ctx, "frames")
