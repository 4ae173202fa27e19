from .synthetic import DataConfig, DataLoader, batch_at

__all__ = ["DataConfig", "DataLoader", "batch_at"]
