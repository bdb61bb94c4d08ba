"""Data substrate: the deterministic synthetic token pipeline."""
from repro_torch.data.pipeline import DataConfig, SyntheticLM, make_pipeline

__all__ = ["DataConfig", "SyntheticLM", "make_pipeline"]
