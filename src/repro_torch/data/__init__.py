from repro_torch.data.pipeline import DataConfig, data_iterator, synthetic_batch

__all__ = ["DataConfig", "synthetic_batch", "data_iterator"]
