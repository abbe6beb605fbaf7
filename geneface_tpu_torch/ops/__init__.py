from geneface_tpu_torch.ops.activations import trunc_exp
from geneface_tpu_torch.ops.compaction import (
    CompactPlan,
    compact_gather,
    make_compact_plan,
    segmented_cumsum,
    waterfill_valid,
)
from geneface_tpu_torch.ops.encoders import (
    GridMeta,
    freq_encode,
    freq_encode_output_dim,
    make_grid_meta,
    sh_encode,
)
from geneface_tpu_torch.ops.fused_grid import (
    FusedGridMeta,
    dense_view,
    fused_grid_encode,
    make_fused_grid_meta,
)
from geneface_tpu_torch.ops.raymarch import (
    MarchResult,
    composite_rays,
    march_rays_lattice,
    march_rays_train,
    near_far_from_aabb,
    occupied_cell_aabb,
    pack_occ_blocks,
)
from geneface_tpu_torch.ops.morton import dilate_grid3d
from geneface_tpu_torch.ops.scatter import (
    gather_rows,
    gather_rows_plain,
    launch_gather_rows,
    launch_scatter_add_rows,
    scatter_add_rows,
    scatter_add_rows_plain,
)

__all__ = [
    "trunc_exp",
    "CompactPlan",
    "compact_gather",
    "make_compact_plan",
    "segmented_cumsum",
    "waterfill_valid",
    "GridMeta",
    "freq_encode",
    "freq_encode_output_dim",
    "make_grid_meta",
    "sh_encode",
    "FusedGridMeta",
    "dense_view",
    "fused_grid_encode",
    "make_fused_grid_meta",
    "MarchResult",
    "composite_rays",
    "march_rays_lattice",
    "march_rays_train",
    "near_far_from_aabb",
    "occupied_cell_aabb",
    "pack_occ_blocks",
    "dilate_grid3d",
    "gather_rows",
    "gather_rows_plain",
    "launch_gather_rows",
    "launch_scatter_add_rows",
    "scatter_add_rows",
    "scatter_add_rows_plain",
]
