# The paper's primary contribution: reduced-precision streaming COO SpMV + PPR.
from repro_torch.core.coo import (
    BlockedCOO,
    COOGraph,
    EdgeMergeInfo,
    merge_edge_delta,
    quantize_values,
)
from repro_torch.core.fixed_point import (
    BITWIDTH_TO_FORMAT,
    PAPER_FORMATS,
    Q1_19,
    Q1_21,
    Q1_23,
    Q1_25,
    QFormat,
    format_for_bits,
    widen_u32,
    wrap_u32,
)
from repro_torch.core.ppr import (
    PPRConfig,
    batched_ppr,
    make_ppr_fixed,
    make_ppr_fixed_step,
    make_ppr_sharded_fixed_step,
    make_ppr_sharded_float_step,
    personalization_matrix,
    personalization_matrix_fixed,
    ppr_float,
    ppr_step_float,
    run_ppr,
)
from repro_torch.core.spmv import (
    make_sharded_spmv,
    make_sharded_spmv_fixed,
    partition_edges_by_dst,
    sharded_vertex_layout,
    spmv_fixed,
    spmv_float,
    spmv_kernel,
)

__all__ = [
    "COOGraph", "BlockedCOO", "EdgeMergeInfo", "merge_edge_delta",
    "quantize_values", "QFormat", "format_for_bits",
    "Q1_19", "Q1_21", "Q1_23", "Q1_25", "PAPER_FORMATS", "BITWIDTH_TO_FORMAT",
    "wrap_u32", "widen_u32",
    "PPRConfig", "run_ppr", "batched_ppr", "ppr_float", "make_ppr_fixed",
    "ppr_step_float", "make_ppr_fixed_step",
    "make_ppr_sharded_float_step", "make_ppr_sharded_fixed_step",
    "personalization_matrix", "personalization_matrix_fixed",
    "spmv_float", "spmv_fixed", "spmv_kernel",
    "make_sharded_spmv", "make_sharded_spmv_fixed",
    "partition_edges_by_dst", "sharded_vertex_layout",
]
