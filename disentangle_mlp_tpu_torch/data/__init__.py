from .pipeline import (DataLoader, ImageFolderSource, SyntheticSource,
                       get_data_loader)

__all__ = [
    "DataLoader",
    "ImageFolderSource",
    "SyntheticSource",
    "get_data_loader",
]
