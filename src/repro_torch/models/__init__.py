from repro_torch.models.transformer import ModelApi, build_model, init_params

__all__ = ["ModelApi", "build_model", "init_params"]
