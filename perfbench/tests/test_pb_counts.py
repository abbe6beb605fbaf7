"""The yardstick's operation and byte counts against shapes worked by hand."""

from counts import bytes as by
from counts import flops as fl
from pbcore import scene


def test_head_sample_flops_by_hand():
    cfg = scene.config("radnerf_head")
    # ambient 32·128 + 128·128 + 128·2; sigma 64·128 + 128·128 + 128·129;
    # colour (16 + 128)·128 + 128·3 multiply-adds
    macs = (32 * 128 + 128 * 128 + 128 * 2) + (64 * 128 + 128 * 128 + 128 * 129) \
        + (144 * 128 + 128 * 3)
    assert fl.head_sample_flops(cfg) == 2 * macs == 161_280
    assert fl.head_sample_flops(cfg, density_only=True) == 2 * (macs - 144 * 128 - 128 * 3)


def test_torso_ray_flops_by_hand():
    cfg = scene.config("radnerf_torso")
    h = 42 + 54 + 8  # the coordinate's and the pose's frequency codes, the torso code
    macs = (h * 64 + 64 * 64 + 64 * 2) + ((32 + h) * 32 + 32 * 32 + 32 * 4)
    assert fl.torso_ray_flops(cfg) == 2 * macs


def test_peak_seconds():
    assert fl.peak_seconds(989e12, 67e12) == 2.0


def test_kernel_bytes_by_hand():
    # K1: 1,000 int32 rows and [1,000, 8] float32 updates read, [10, 8] sums written
    assert by.k1_bytes(M=1000, W=8, R=10, itemsize=4) == 4000 + 32000 + 320
    # bfloat16 updates read half the bytes
    assert by.k1_bytes(M=1000, W=8, R=10, itemsize=2) == 4000 + 16000 + 320
    # K8: 1,000 indices read, at most 10 distinct table rows read, [1,000, 8] written
    assert by.k8_bytes(M=1000, W=8, R=10, itemsize=4) == 4000 + 320 + 32000
    assert by.k8_bytes(M=4, W=8, R=10, itemsize=4) == 16 + 128 + 128
    calls = [("k1", dict(M=1000, W=8, R=10, itemsize=4, variant="vec")),
             ("k8", dict(M=4, W=8, R=10, itemsize=4))]
    assert by.bound_s(calls, "k1") == 36320 / by.PEAK_BYTES_S
    assert by.bound_s(calls, "k8") == 272 / by.PEAK_BYTES_S


def test_param_specs_match_the_program():
    """The benchmark shapes its weights from the configuration alone; the
    program's model holds exactly these parameters."""
    from geneface_tpu_torch.models.radnerf import model_from_cfg

    for name, torso in (("radnerf_head", False), ("radnerf_torso", True)):
        cfg = scene.config(name)
        mine = {n: tuple(s) for n, s, _ in scene.param_specs(cfg, torso)}
        theirs = {n: tuple(p.shape) for n, p in model_from_cfg(cfg, torso=torso).named_parameters()}
        assert mine == theirs
