from geneface_tpu_torch.ops.activations import trunc_exp
from geneface_tpu_torch.ops.compaction import (
    CompactPlan,
    compact_gather,
    make_compact_plan,
    segmented_cumsum,
    waterfill_valid,
)
from geneface_tpu_torch.ops.encoders import GridMeta, make_grid_meta, sh_encode
from geneface_tpu_torch.ops.fused_grid import (
    FusedGridMeta,
    dense_view,
    fused_grid_encode,
    make_fused_grid_meta,
)
from geneface_tpu_torch.ops.raymarch import (
    MarchResult,
    march_rays_lattice,
    near_far_from_aabb,
    occupied_cell_aabb,
    pack_occ_blocks,
)
from geneface_tpu_torch.ops.scatter import scatter_add_rows, scatter_add_rows_plain

__all__ = [
    "trunc_exp",
    "CompactPlan",
    "compact_gather",
    "make_compact_plan",
    "segmented_cumsum",
    "waterfill_valid",
    "GridMeta",
    "make_grid_meta",
    "sh_encode",
    "FusedGridMeta",
    "dense_view",
    "fused_grid_encode",
    "make_fused_grid_meta",
    "MarchResult",
    "march_rays_lattice",
    "near_far_from_aabb",
    "occupied_cell_aabb",
    "pack_occ_blocks",
    "scatter_add_rows",
    "scatter_add_rows_plain",
]
