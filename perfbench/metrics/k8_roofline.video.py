"""K8 (the row gather) over the video window: the HBM bound of every call
over the device time of its kernels, in percent."""

from pbcore.readers import roofline_percent


def read(ctx):
    return roofline_percent(ctx, "k8")
