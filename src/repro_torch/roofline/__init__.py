from repro_torch.roofline.analysis import (
    HBM_BW,
    LINK_BW,
    PEAK_FLOPS,
    PEAK_FLOPS_F32,
    CostCounter,
    RooflineTerms,
    collective_bytes,
    model_flops_forward,
    model_flops_train,
    roofline,
)

__all__ = [
    "roofline", "RooflineTerms", "collective_bytes", "CostCounter",
    "model_flops_train", "model_flops_forward",
    "PEAK_FLOPS", "PEAK_FLOPS_F32", "HBM_BW", "LINK_BW",
]
