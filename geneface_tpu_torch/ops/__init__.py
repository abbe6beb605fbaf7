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
from geneface_tpu_torch.ops.geometry import (
    extract_fields,
    extract_geometry,
    linear_to_srgb,
    marching_tetrahedra,
    sph_from_ray,
    srgb_to_linear,
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
from geneface_tpu_torch.ops.volume import raw2outputs, render_rays, sample_pdf

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
    "extract_fields",
    "extract_geometry",
    "linear_to_srgb",
    "marching_tetrahedra",
    "sph_from_ray",
    "srgb_to_linear",
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
    "raw2outputs",
    "render_rays",
    "sample_pdf",
]
