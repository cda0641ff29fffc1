"""The path list and the sliding-window slices of I3D's stacks.

Counterpart of ``video_features_tpu/io/paths.py``: a path entry is a
video path, or a ``(video_path, flow_dir)`` pair when I3D reads its flow
from disk (``--flow_type flow``).
"""

from __future__ import annotations

import os
import pathlib
from typing import List, Tuple, Union

PathEntry = Union[str, Tuple[str, str]]


def form_slices(size: int, stack_size: int, step_size: int) -> List[Tuple[int, int]]:
    """(start, end) windows of ``stack_size`` frames every ``step_size``
    over ``size`` frames; the ragged tail is dropped."""
    full_stack_num = (size - stack_size) // step_size + 1
    return [(i * step_size, i * step_size + stack_size) for i in range(full_stack_num)]


def form_list_from_user_input(cfg) -> List[PathEntry]:
    """The path list, by precedence: a file with one path per line, then
    ``video_dir`` (zipped with ``flow_dir`` by sorted stem, a pair kept
    only where the stems match), then ``video_paths`` (zipped with
    ``flow_paths`` the same way). Every path must exist."""
    if cfg.file_with_video_paths is not None:
        with open(cfg.file_with_video_paths) as rfile:
            path_list: List[PathEntry] = [line.strip() for line in rfile if line.strip()]
    elif cfg.video_dir is not None:
        if cfg.flow_dir is None:
            path_list = sorted(str(p) for p in pathlib.Path(cfg.video_dir).glob("*"))
        else:
            v_list = sorted(pathlib.Path(cfg.video_dir).glob("*"), key=lambda x: x.stem)
            f_list = sorted(pathlib.Path(cfg.flow_dir).glob("*"), key=lambda x: x.stem)
            path_list = [(str(v), str(f)) for v, f in zip(v_list, f_list) if v.stem == f.stem]
    elif cfg.video_paths is not None:
        if cfg.flow_paths is None:
            path_list = list(cfg.video_paths)
        else:
            path_list = [(v, f) for v, f in zip(cfg.video_paths, cfg.flow_paths)
                         if pathlib.Path(v).stem == pathlib.Path(f).stem]
    else:
        raise ValueError("no video provided")
    for entry in path_list:
        for p in entry if isinstance(entry, tuple) else (entry,):
            if not os.path.exists(p):
                raise ValueError(f"path does not exist: {p}")
    return path_list


def video_path_of(entry: PathEntry) -> str:
    """The video of a path entry (an entry may pair it with a flow dir)."""
    return entry[0] if isinstance(entry, (tuple, list)) else entry
