"""Hand-written CUDA kernels for the paper's compute hot-spots, for Hopper.

- coo_spmv:   the paper's streaming COO SpMM (csrc/coo_spmv.cu), float32
              and bit-exact fixed point.
- fused_ppr:  one whole eq. (1) iteration (csrc/fused_ppr.cu): dangling-mass
              fold, SpMV, combine and residual.
  Both read the pad-free, dst-sorted edge stream of ``dst_stream.py``
  through the shared device code of csrc/dst_stream.cuh.
- topk_select: a wave's top-K, one pass over the final state
               (csrc/topk_select.cu).
- fixed_matmul:    reduced-precision serving matmul, f32/bf16 activations x
                   int8 per-channel weights (csrc/fixed_matmul.cu).
- flash_attention: blocked online-softmax attention for the LM stack, causal
                   / local-window / GQA (csrc/flash_attention.cu).

Every kernel has its plain PyTorch version beside it: a wrapper runs the
plain version for CPU tensors and launches the kernel (or raises) for CUDA
tensors.  ``ops.py`` holds the public wrappers; ``ref.py`` the oracles;
``_build.py`` compiles ``csrc/`` with nvcc at first CUDA use.
"""
from repro_torch.kernels import ops, ref
from repro_torch.kernels.coo_spmv import coo_spmv_kernel
from repro_torch.kernels.fixed_matmul import quantized_matmul_kernel
from repro_torch.kernels.flash_attention import flash_attention, flash_attention_gqa
from repro_torch.kernels.fused_ppr import dangling_mass, fused_ppr_iteration
# the wrapper under another name: ``kernels.topk_select`` stays the module
from repro_torch.kernels.topk_select import topk_select as _topk_select

#: every kernel wrapper, by name; each carries a ``launches`` count
KERNEL_WRAPPERS = {
    "coo_spmv": coo_spmv_kernel,
    "fused_ppr_dangling_mass": dangling_mass,
    "fused_ppr_iteration": fused_ppr_iteration,
    "topk_select": _topk_select,
    "quantized_matmul": quantized_matmul_kernel,
    "flash_attention": flash_attention_gqa,
}


def launch_counts() -> dict:
    """Launches per kernel wrapper since the last reset."""
    return {name: fn.launches for name, fn in KERNEL_WRAPPERS.items()}


def reset_launch_counts() -> None:
    for fn in KERNEL_WRAPPERS.values():
        fn.launches = 0


__all__ = ["ops", "ref", "coo_spmv_kernel", "fused_ppr_iteration",
           "dangling_mass", "quantized_matmul_kernel", "flash_attention",
           "flash_attention_gqa", "KERNEL_WRAPPERS", "launch_counts",
           "reset_launch_counts"]
