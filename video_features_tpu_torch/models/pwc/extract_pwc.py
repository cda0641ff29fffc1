"""PWC-Net optical-flow extractor.

Counterpart of ``video_features_tpu/models/pwc/extract_pwc.py``: the
shared pair-window runtime (``models/common/flow_extract.py``) with
PWC-Net, which needs no host-side padding (its /64 stretch is part of
its forward). Flow comes back at the frames' resolution as
``<stem>_pwc.npy`` (T-1, 2, H, W).
"""

from __future__ import annotations

from video_features_tpu_torch.models.common.flow_extract import PairwiseFlowExtractor
from video_features_tpu_torch.models.pwc.convert import convert_state_dict
from video_features_tpu_torch.models.pwc.model import FP32_PARAMS, PWCNet, init_weights


class ExtractPWC(PairwiseFlowExtractor):
    checkpoint = "the sniklaus PWC-Net state dict (pwc_net_sintel.pt)"
    _convert_state_dict = staticmethod(convert_state_dict)
    _init_weights = staticmethod(init_weights)
    _fp32_params = FP32_PARAMS

    def _model(self) -> PWCNet:
        return PWCNet()
