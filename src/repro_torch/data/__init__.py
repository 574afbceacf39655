from .pipeline import DataConfig, SyntheticLM, make_pipeline  # noqa: F401
