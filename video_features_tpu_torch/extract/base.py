"""Extractor runtime: the per-video loop every feature type shares.

Counterpart of ``video_features_tpu/extract/base.py``, cut to its serial
loop: the path list is formed in ``__init__``, the model is built once
per device (``warmup``), and ``__call__`` runs the videos in order. Each
video is isolated: an error is printed and the loop goes on. Results go
to the output sink or, with ``external_call``, back to the caller in
order. ``--resume`` skips a video whose output files all exist.

A subclass implements ``_build(device)`` (the model state), ``prepare``
(host: decode and preprocess one video) and ``forward`` (device: the
model on a prepared payload, returning the feature dict).
"""

from __future__ import annotations

import os
import traceback
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from video_features_tpu_torch.config import ExtractionConfig
from video_features_tpu_torch.devices import pin_fp32, resolve_device
from video_features_tpu_torch.io.paths import form_list_from_user_input, video_path_of
from video_features_tpu_torch.io.sink import action_on_extraction, expected_output_files


class BaseExtractor:
    feature_type: str = ""

    def __init__(self, config: ExtractionConfig, external_call: bool = False) -> None:
        self.config = config
        self.external_call = external_call
        if not self.feature_type:
            self.feature_type = self.config.feature_type
        self.path_list = form_list_from_user_input(self.config)
        # features land in <output_path>/<feature_type>/ unless output_direct
        if self.config.output_direct:
            self.output_path = self.config.output_path
        else:
            self.output_path = os.path.join(self.config.output_path, self.feature_type)
        self._device_state: Dict[torch.device, Any] = {}
        pin_fp32()

    def feature_keys(self) -> List[str]:
        """The keys a feature dict carries, whose files ``--resume`` probes
        (i3d overrides this with its streams)."""
        return [self.feature_type]

    def _already_done(self, entry) -> bool:
        files = expected_output_files(
            self.feature_keys(), video_path_of(entry), self.output_path,
            self.config.on_extraction, self.config.output_direct,
        )
        return bool(files) and all(os.path.exists(f) for f in files)

    def _build(self, device: torch.device) -> Any:
        raise NotImplementedError

    def prepare(self, entry) -> Any:
        raise NotImplementedError

    def forward(self, state: Any, payload: Any) -> Dict[str, np.ndarray]:
        raise NotImplementedError

    def warmup(self, device: torch.device) -> Any:
        """Build (once) and cache this device's model state."""
        state = self._device_state.get(device)
        if state is None:
            state = self._device_state[device] = self._build(device)
        return state

    def __call__(
        self,
        indices: Optional[Sequence[int]] = None,
        device: Optional[torch.device] = None,
    ) -> Optional[List[Dict[str, np.ndarray]]]:
        if indices is None:
            indices = range(len(self.path_list))
        if device is None:
            device = resolve_device(self.config)
        state = self.warmup(device)
        results: List[Dict[str, np.ndarray]] = []
        for idx in indices:
            entry = self.path_list[int(idx)]
            if self.config.resume and not self.external_call and self._already_done(entry):
                print(f"Skipping {video_path_of(entry)}: outputs exist (--resume)")
                continue
            try:
                feats_dict = self.forward(state, self.prepare(entry))
                if self.external_call:
                    results.append(feats_dict)
                else:
                    action_on_extraction(
                        feats_dict, video_path_of(entry), self.output_path,
                        self.config.on_extraction, self.config.output_direct,
                    )
            except KeyboardInterrupt:
                raise
            except Exception:  # noqa: BLE001 - one bad video must not stop the run
                print(f"An error occurred extracting {video_path_of(entry)}:")
                traceback.print_exc()
                print("Continuing...")
        return results if self.external_call else None
