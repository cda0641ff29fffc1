"""VGGish audio extractor, for ``vggish`` and ``vggish_torch``.

Counterpart of ``video_features_tpu/models/vggish/extract_vggish.py``.
Per input: a ``.wav`` is read directly, a video container ripped through
ffmpeg (``io/audio.py``); the waveform becomes (96, 64) log-mel examples
on the host (``mel.py``), zero-padded to a bucketed batch; the VGG runs
on the device under ``torch.inference_mode()`` and the first n rows come
back. Output: ``{feature_type: (n, 128) float32}``, n = duration / 0.96 s,
with no fps or timestamp keys; a clip shorter than 0.96 s gives (0, 128).
The raw embeddings, as both reference extractors emit them: the PCA
postprocess (``model.postprocess``) is for library users. With
``--video_batch N`` the example batches of N clips run as one forward.

``--sharding mesh``: data parallelism over the 0.96 s example batch. The
VGG is replicated on the mesh's data rows (``parallel/sharding.py::
replicate``), each batch (and each fused group) splits over the rows
(``split_rows``; a row left without examples sits out), and the rows'
embeddings gather onto the first device before the copy to the host.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from video_features_tpu_torch.extract.base import BaseExtractor, device_of
from video_features_tpu_torch.extract.ingest import HostCopy, place_batch
from video_features_tpu_torch.io.audio import load_audio_for_model
from video_features_tpu_torch.io.paths import video_path_of
from video_features_tpu_torch.models.common.weights import (
    load_checked,
    load_params,
    random_init_fallback,
)
from video_features_tpu_torch.models.vggish.convert import convert_state_dict, params_from_jax
from video_features_tpu_torch.models.vggish.mel import SAMPLE_RATE, waveform_to_examples
from video_features_tpu_torch.models.vggish.model import VGGISH_EMBEDDING_DIM, VGGish, init_weights
from video_features_tpu_torch.ops.window import bucket_size, pad_batch
from video_features_tpu_torch.parallel.sharding import Replicas, is_mesh, replicate


class ExtractVGGish(BaseExtractor):
    media_need = "audio"  # the preflight probe checks a wav's header, or opens a video's
    # --sharding mesh: pure data parallelism over the example batch, the
    # weights replicated (parallel/scheduler.py reads this)
    mesh_capable = True

    def _build(self, device):
        """The VGG on ``device``; on a mesh, one copy a distinct device of
        its data rows (``sharding.replicate``)."""
        if is_mesh(device):
            return replicate(self._build, device)
        model = VGGish()
        if self.config.weights_path:
            load_checked(model, load_params(self.config.weights_path, convert_state_dict,
                                            params_from_jax), self.feature_type)
        else:
            random_init_fallback(self.config, self.feature_type,
                                 "a torchvggish state dict (vggish-10086976.pth), or its "
                                 "converted .msgpack / orbax directory")
            init_weights(model)
        return model.to(device).eval()

    def prepare(self, entry):
        """Host half: ((B, 1, 96, 64) float32 examples padded to a bucket, n)."""
        samples = load_audio_for_model(
            video_path_of(entry), SAMPLE_RATE, self.tmp_path, self.config.keep_tmp_files
        )
        examples = waveform_to_examples(samples, SAMPLE_RATE)  # (n, 96, 64)
        n = examples.shape[0]
        if n == 0:
            return None, 0
        return pad_batch(examples[:, None], bucket_size(n, buckets=self.config.shape_buckets)), n

    @staticmethod
    def _embed(model, x: np.ndarray) -> torch.Tensor:
        """Host examples -> embeddings on the model's device: placed whole,
        or on a mesh split over the data rows and gathered."""
        if isinstance(model, Replicas):
            return model.run(x)
        return model(place_batch(x, device_of(model)))

    # --- the device half, split (extract/base.py): H2D, forward and D2H
    # enqueued at dispatch, waited for at fetch
    def dispatch_prepared(self, model: VGGish, payload):
        x, n = payload
        if n == 0:
            return None, 0
        with torch.inference_mode():
            return HostCopy(self._embed(model, x)[:n]), n

    def fetch_dispatched(self, handle) -> Dict[str, np.ndarray]:
        out, n = handle
        if n == 0:
            return {self.feature_type: np.zeros((0, VGGISH_EMBEDDING_DIM), np.float32)}
        return {self.feature_type: out.numpy()}

    # --- cross-video aggregation (--video_batch): N clips' bucketed
    # example batches concatenate into one VGG forward, sliced apart at
    # fetch. A short clip gives 1-5 (96, 64) examples. Over
    # AGG_MAX_EXAMPLES (~25 MB of fp32 per payload; an hour of audio) a
    # clip dispatches alone rather than parking N - 1 such buffers on the
    # host; a clip under 0.96 s has nothing to fuse.
    AGG_MAX_EXAMPLES = 1024

    def agg_key(self, payload):
        x, n = payload
        if n == 0 or x.shape[0] > self.AGG_MAX_EXAMPLES:
            return None
        return x.shape  # the bucketed (B, 1, 96, 64)

    def dispatch_group(self, model: VGGish, payloads):
        """One forward over the group's batches, unpadded when the group
        is partial (eager PyTorch compiles no shape)."""
        bucket = payloads[0][0].shape[0]
        x = np.concatenate([p[0] for p in payloads], axis=0)
        with torch.inference_mode():
            out = HostCopy(self._embed(model, x))
        return out, [(i * bucket, n) for i, (_, n) in enumerate(payloads)]

    def fetch_group(self, handle):
        out, metas = handle
        arr = out.numpy()
        return [{self.feature_type: arr[off : off + n]} for off, n in metas]
