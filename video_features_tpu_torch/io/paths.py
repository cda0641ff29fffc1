"""The video list (``--file_with_video_paths`` or ``--video_paths``) and
the sliding-window slices of I3D's stacks.

Counterpart of ``video_features_tpu/io/paths.py``.
"""

from __future__ import annotations

import os
from typing import List, Tuple, Union

PathEntry = Union[str, Tuple[str, str]]


def form_slices(size: int, stack_size: int, step_size: int) -> List[Tuple[int, int]]:
    """(start, end) windows of ``stack_size`` frames every ``step_size``
    over ``size`` frames; the ragged tail is dropped."""
    full_stack_num = (size - stack_size) // step_size + 1
    return [(i * step_size, i * step_size + stack_size) for i in range(full_stack_num)]


def form_list_from_user_input(cfg) -> List[PathEntry]:
    """The path list: a file with one path per line wins over
    ``video_paths``. Every path must exist."""
    if cfg.file_with_video_paths is not None:
        with open(cfg.file_with_video_paths) as rfile:
            path_list: List[PathEntry] = [line.strip() for line in rfile if line.strip()]
    elif cfg.video_paths is not None:
        path_list = list(cfg.video_paths)
    else:
        raise ValueError("no video provided")
    for p in path_list:
        if not os.path.exists(p):
            raise ValueError(f"path does not exist: {p}")
    return path_list


def video_path_of(entry: PathEntry) -> str:
    """The video of a path entry (an entry may pair it with a flow dir)."""
    return entry[0] if isinstance(entry, (tuple, list)) else entry
