"""More than one device: queue mode (one worker thread per device over a
shared queue of videos) and mesh mode (one sharded forward over a
(data, model) grid of devices). Counterpart of
``video_features_tpu/parallel/``."""

from video_features_tpu_torch.parallel.devices import resolve_devices  # noqa: F401
from video_features_tpu_torch.parallel.scheduler import (  # noqa: F401
    mesh_feature_extraction,
    parallel_feature_extraction,
)
