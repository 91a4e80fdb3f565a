"""Synthetic smoke datasets (`data/synthetic.py`)."""
from .synthetic import SyntheticSmokeDataset, create_data_loaders, generate_dataset

__all__ = ["SyntheticSmokeDataset", "create_data_loaders", "generate_dataset"]
