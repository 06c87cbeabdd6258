"""Data pipeline of the port: the multi-task dataset manifest and the
threaded prefetching loader."""

from .dataset import (  # noqa: F401
    BatchLoader,
    MultiTaskDataset,
    collect_image_paths,
    map_folder_to_class,
)
