"""RAD-NeRF head and torso: fields, condition encoders and the renderers."""

from geneface_tpu_torch.models.radnerf.radnerf import COND_IN_DIMS, RADNeRF
from geneface_tpu_torch.models.radnerf.radnerf_torso import RADNeRFTorso, sample_torso_occupancy
from geneface_tpu_torch.models.radnerf.renderer import (
    OccupancyState,
    OccupancyView,
    TorsoOccupancyState,
    init_occupancy,
    init_torso_occupancy,
    kdop_hit,
    make_aabb,
    mark_untrained_grid,
    occupancy_view,
    occupied_kdop,
    render_rays_radnerf,
    render_rays_radnerf_torso,
    torso_occupancy_mask,
    update_extra_state,
    update_torso_occupancy,
)

__all__ = [
    "COND_IN_DIMS",
    "RADNeRF",
    "RADNeRFTorso",
    "sample_torso_occupancy",
    "OccupancyState",
    "OccupancyView",
    "TorsoOccupancyState",
    "init_occupancy",
    "init_torso_occupancy",
    "mark_untrained_grid",
    "update_extra_state",
    "update_torso_occupancy",
    "kdop_hit",
    "make_aabb",
    "occupancy_view",
    "occupied_kdop",
    "render_rays_radnerf",
    "render_rays_radnerf_torso",
    "torso_occupancy_mask",
    "model_from_cfg",
]

_CFG_KEYS = {
    "cond_type": "idexp_lm3d_normalized",
    "cond_out_dim": 64,
    "cond_win_size": 1,
    "smo_win_size": 5,
    "with_att": True,
    "bound": 1,
    "grid_type": "tiledgrid",
    "grid_interpolation_type": "linear",
    "log2_hashmap_size": 16,
    "desired_resolution": 2048,
    "grid_num_levels": 8,
    "grid_level_dim": 4,
    "num_layers_ambient": 3,
    "hidden_dim_ambient": 128,
    "ambient_out_dim": 2,
    "num_layers_sigma": 3,
    "hidden_dim_sigma": 128,
    "geo_feat_dim": 128,
    "num_layers_color": 2,
    "hidden_dim_color": 128,
    "individual_embedding_num": 13000,
    "individual_embedding_dim": 4,
    "grid_backend": "fused",
    "fused_single_table": False,
    "fused_row_lanes": 256,
    "grid_compute_dtype": "f32",
    "fused_ungroup_coarse": 0,
    "ambient_ungroup_coarse": -1,
    "fused_coarse_run": 1,
    "ambient_single_table": False,
    "grid_bwd_dtype": "same",
}


_TORSO_CFG_KEYS = {
    "torso_shrink": 0.8,
    "torso_individual_embedding_dim": 8,
    "torso_head_aware": False,
}


def model_from_cfg(cfg, torso: bool = False, **extra) -> RADNeRF:
    """Config → :class:`RADNeRF` keyword arguments (the config→kwargs map of
    the JAX task's ``model_from_cfg``), or with ``torso`` a
    :class:`RADNeRFTorso` with the config's torso keys; ``extra``
    overrides, e.g. ``dtype``."""
    kw = {k: cfg.get(k, v) for k, v in _CFG_KEYS.items()}
    if torso:
        kw.update({k: cfg.get(k, v) for k, v in _TORSO_CFG_KEYS.items()})
    kw.update(extra)
    return (RADNeRFTorso if torso else RADNeRF)(**kw)
