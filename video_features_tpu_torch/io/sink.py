"""Output sink: what happens to an extracted feature dict.

Counterpart of ``video_features_tpu/io/sink.py``: features are printed
with max/mean/min stats, or saved as ``<stem>_<key>.npy`` /
``<stem>_<key>.pkl`` (``<stem>.<ext>`` with ``output_direct``), or, for
(T, 2, H, W) flow under ``save_jpg``, written as the uint8-quantized
``<stem>/flow_x_<n>.jpg`` / ``flow_y_<n>.jpg`` pairs that I3D's
``--flow_type flow`` reads back; the meta keys ``fps`` and
``timestamps_ms`` are never saved. Same file names as the JAX package, so
either package's output can ``--resume`` the other's.
"""

from __future__ import annotations

import json
import os
import pathlib
import pickle
import shutil
import threading
import uuid
from typing import Any, Dict, List, Optional

import numpy as np

from video_features_tpu_torch.ops.preprocess import flow_quantize_uint8_np
from video_features_tpu_torch.runtime import faults

META_KEYS = ("fps", "timestamps_ms")
_SUFFIX = {"save_numpy": "npy", "save_pickle": "pkl"}


def _tmp_name(path: str) -> str:
    """A staging name no other process or thread writes: a run killed
    mid-save leaves no truncated file for ``--resume`` to trust."""
    return f"{path}.{os.getpid()}-{threading.get_ident()}-{uuid.uuid4().hex[:8]}.tmp"


def atomic_copy(src: str, dest: str) -> None:
    """Copy ``src`` to ``dest`` through a uniquely-named tmp file +
    ``os.replace`` — the same commit protocol as the feature saver
    below, shared with the content-addressed cache (extract/cache.py)
    so a kill mid-materialize can never leave a truncated output that
    ``--resume`` (or a cache lookup) would then trust as complete."""
    os.makedirs(os.path.dirname(dest) or ".", exist_ok=True)
    tmp = _tmp_name(dest)
    try:
        shutil.copyfile(src, tmp)
        os.replace(tmp, dest)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def atomic_write_json(path: str, doc: Any, *, indent: Optional[int] = 1,
                      sort_keys: bool = True) -> str:
    """Publish ``doc`` as JSON at ``path``: write a same-directory tmp
    file, then one ``os.replace``, so readers see the old file or the new
    one, never a torn one. Returns ``path``."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = _tmp_name(path)
    try:
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(doc, f, indent=indent, sort_keys=sort_keys)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    return path


def output_file_name(name: str, key: str, on_extraction: str, output_direct: bool) -> str:
    """``<stem>_<key>.<ext>``; '/' in a key (CLIP-ViT-B/32) becomes '-'."""
    suffix = _SUFFIX[on_extraction]
    if output_direct:
        return f"{name}.{suffix}"
    return f"{name}_{key.replace('/', '-')}.{suffix}"


def expected_output_files(
    feature_keys, video_path: str, output_path: str, on_extraction: str,
    output_direct: bool = False,
) -> List[str]:
    """The files a successful save would write: the ``--resume`` probe.
    Empty for ``print``, which writes nothing, and for ``save_jpg``, whose
    per-frame directories have no cheap completeness probe: both always
    recompute."""
    if on_extraction not in _SUFFIX:
        return []
    name = pathlib.Path(video_path).stem
    return list(dict.fromkeys(
        os.path.join(output_path, output_file_name(name, key, on_extraction, output_direct))
        for key in feature_keys
    ))


def action_on_extraction(
    feats_dict: Dict[str, np.ndarray],
    video_path: str,
    output_path: str,
    on_extraction: str,
    output_direct: bool = False,
) -> List[str]:
    """Print or save every non-meta key; returns warnings (empty values)."""
    name = pathlib.Path(video_path).stem
    warnings: List[str] = []
    for key, value in feats_dict.items():
        if key in META_KEYS:
            continue
        value = np.asarray(value)
        if on_extraction == "print":
            print(key)
            print(value)
            print(f"max: {value.max():.8f}; mean: {value.mean():.8f}; min: {value.min():.8f}")
            print()
        elif on_extraction in _SUFFIX:
            fpath = os.path.join(
                output_path, output_file_name(name, key, on_extraction, output_direct)
            )
            os.makedirs(os.path.dirname(fpath), exist_ok=True)
            if len(value) == 0:
                msg = f"the value is empty for {key} @ {fpath}"
                print(f"Warning: {msg}")
                warnings.append(msg)
            tmp = _tmp_name(fpath)
            try:
                with open(tmp, "wb") as f:
                    if on_extraction == "save_numpy":
                        np.save(f, value)
                    else:
                        pickle.dump(value, f)
                # an injected sink fault lands between write and rename:
                # bytes on disk, nothing committed
                faults.fire("sink")
                os.replace(tmp, fpath)
            except BaseException:
                try:
                    os.unlink(tmp)
                except OSError:
                    pass
                raise
        elif on_extraction == "save_jpg":
            # flow (T, 2, H, W) float -> per-pair grayscale JPEGs of the
            # uint8-quantized flow (clamp to ±20, 128 + 255/40 f), named
            # flow_x_<n>.jpg / flow_y_<n>.jpg so that --flow_type flow
            # --flow_dir reads them back
            if value.ndim != 4 or value.shape[1] != 2:
                raise ValueError(
                    f"save_jpg needs (T, 2, H, W) flow, got {value.shape} "
                    f"for key {key!r} (use raft/pwc features)"
                )
            from PIL import Image

            quant = flow_quantize_uint8_np(value)
            vdir = os.path.join(output_path, name)
            os.makedirs(vdir, exist_ok=True)
            for f_num in range(quant.shape[0]):
                for ch, axis in enumerate("xy"):
                    Image.fromarray(quant[f_num, ch], mode="L").save(
                        os.path.join(vdir, f"flow_{axis}_{f_num:0>5d}.jpg"), quality=95,
                    )
        else:
            raise NotImplementedError(f"on_extraction: {on_extraction} is not implemented")
    return warnings
