"""Matrix operations of the RAD-NeRF MLPs, from the configuration's widths.

A sample of the head runs the ambient MLP (the position feature against its
first layer; the condition's part is one row a call), the sigma MLP and the
colour MLP (directions and geometry feature per sample; the individual code
one row a call). A density query (the occupancy sweep) runs the ambient and
sigma MLPs only. A torso ray runs the deform and canonical MLPs. A
multiply-add counts two operations; a trained part's backward counts two
forwards more.
"""

#: H100 SXM dense peaks (NVIDIA's data sheet, at 700 W): bfloat16 on the
#: tensor cores, float32 outside them
PEAK_BF16 = 989e12
PEAK_F32 = 67e12


def _layers(din: int, dout: int, hidden: int, n: int) -> int:
    dims = [din] + [hidden] * (n - 1) + [dout]
    return sum(a * b for a, b in zip(dims, dims[1:]))


def head_sample_flops(cfg: dict, density_only: bool = False) -> int:
    LC = int(cfg["grid_num_levels"]) * int(cfg["grid_level_dim"])
    geo = int(cfg["geo_feat_dim"])
    macs = _layers(LC, 2, int(cfg["hidden_dim_ambient"]), int(cfg["num_layers_ambient"]))
    macs += _layers(2 * LC, 1 + geo, int(cfg["hidden_dim_sigma"]), int(cfg["num_layers_sigma"]))
    if not density_only:
        macs += _layers(16 + geo, 3, int(cfg["hidden_dim_color"]), int(cfg["num_layers_color"]))
    return 2 * macs


def torso_ray_flops(cfg: dict) -> int:
    LC = int(cfg["grid_num_levels"]) * int(cfg["grid_level_dim"])
    h = 2 * 21 + 6 * 9 + int(cfg["torso_individual_embedding_dim"])
    return 2 * (_layers(h, 2, 64, 3) + _layers(LC + h, 4, 32, 3))


def peak_seconds(bf16_flops: float, f32_flops: float) -> float:
    """Seconds the chip needs at its peaks for this work."""
    return bf16_flops / PEAK_BF16 + f32_flops / PEAK_F32
