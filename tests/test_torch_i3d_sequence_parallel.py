"""``I3D.forward_sharded`` (sequence parallelism over the time axis)
against ``I3D.forward``.

The same seeded network (BatchNorm statistics away from identity, so
each op's zero padding shows) runs one clip whole and split into time
blocks of 8 frames, the last ragged (``parallel/sharding.py::
row_sizes``), over ``data`` 2, 3, 4 and 8 rows of one CPU device and
lengths 8 to 65:

- a 10-frame clip at ``data`` 8 runs on two rows (8 + 2), the other six
  sit out; at 33 and 65 frames a last block of 1 frame is left without
  outputs by the stem and drops out;
- 8 frames are too few for the network's last pool: both forwards fail
  alike;
- fp32, both ``--conv3d_impl`` lowerings: within ``ATOL`` (sums over
  blocks and convolutions over shorter inputs reorder the additions;
  measured at most 6e-8 on features of scale ~0.3);
- bf16 (``cast_for_compute``, the norms' folds and the pooling fp32):
  both sides run the same bf16 graph, so they differ only where a
  convolution's blocking over a shorter input rounds an accumulation
  differently; held to ``BF16_RTOL`` of the features' L2, a tenth of
  ``config.PARITY_CEILINGS[("i3d", "bfloat16", "model")]`` (0.03);
  measured at most 1.1e-7 here.

The network is I3D at ``channel_div`` 16 (64 features): the time axis,
the strides and the pads are the full network's, the widths a sixteenth.
"""

import numpy as np
import pytest
import torch

from video_features_tpu_torch.config import PARITY_CEILINGS
from video_features_tpu_torch.models.common.layers import set_conv3d_impl
from video_features_tpu_torch.models.common.weights import cast_for_compute
from video_features_tpu_torch.models.i3d.model import FP32_PARAMS, I3D, init_weights
from video_features_tpu_torch.parallel.sharding import make_mesh, row_sizes, split_rows

from torch_threads import one_torch_thread  # noqa: F401 - an autouse fixture

ATOL = 1e-5
BF16_RTOL = 3e-3
LENGTHS = (8, 10, 11, 16, 33, 64, 65)
CPU = torch.device("cpu")


def _seeded(dtype=torch.float32):
    model = init_weights(I3D(3, channel_div=16), seed=2)
    rng = np.random.RandomState(2)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm3d):
                n = m.num_features
                for t, lo, hi in ((m.weight, 0.5, 1.5), (m.bias, -0.1, 0.1),
                                  (m.running_mean, -0.1, 0.1), (m.running_var, 0.5, 1.5)):
                    t.copy_(torch.from_numpy(rng.uniform(lo, hi, n).astype(np.float32)))
    return cast_for_compute(model.eval(), dtype, exclude=FP32_PARAMS)


_NETS = {}
_WHOLE = {}


def _net(dtype, impl):
    if (dtype, impl) not in _NETS:
        _NETS[dtype, impl] = set_conv3d_impl(_seeded(dtype), impl)
    return _NETS[dtype, impl]


def _clip(length):
    return np.random.default_rng(length).uniform(-1, 1, (1, length, 224, 224, 3)).astype(
        np.float32)


def _whole(length, dtype, impl):
    """``forward``'s (features, logits), once per case of the module."""
    key = (length, dtype, impl)
    if key not in _WHOLE:
        with torch.inference_mode():
            _WHOLE[key] = _net(dtype, impl)(torch.from_numpy(_clip(length)))
    return _WHOLE[key]


def _sharded(length, data, dtype, impl):
    parts, sizes = split_rows(_clip(length)[0], make_mesh([CPU] * data), block=8)
    assert sizes == row_sizes(length, data, 8)
    with torch.inference_mode():
        return _net(dtype, impl).forward_sharded([p[None] for p in parts])


@pytest.mark.parametrize("impl", ["direct", "decomposed"])
@pytest.mark.parametrize("data", [2, 3, 4, 8])
@pytest.mark.parametrize("length", LENGTHS)
def test_forward_sharded_matches_forward(length, data, impl):
    if length == 8:  # one time step reaches the (2, 7, 7) average pool
        for run in (lambda: _whole(length, torch.float32, impl),
                    lambda: _sharded(length, data, torch.float32, impl)):
            with pytest.raises(RuntimeError, match="smaller than kernel size"):
                run()
        return
    feats, logits = _whole(length, torch.float32, impl)
    got_f, got_l = _sharded(length, data, torch.float32, impl)
    assert got_f.shape == feats.shape == (1, 64) and got_l.shape == logits.shape == (1, 400)
    torch.testing.assert_close(got_f, feats, atol=ATOL, rtol=0)
    torch.testing.assert_close(got_l, logits, atol=ATOL, rtol=0)


@pytest.mark.parametrize("data", [3, 8])
@pytest.mark.parametrize("length", [11, 33, 65])
def test_forward_sharded_bfloat16_runs_the_same_graph(length, data):
    assert BF16_RTOL <= PARITY_CEILINGS[("i3d", "bfloat16", "model")] / 10
    feats, logits = _whole(length, torch.bfloat16, "direct")
    got_f, got_l = _sharded(length, data, torch.bfloat16, "direct")
    assert got_f.dtype == feats.dtype == torch.float32
    for got, want in ((got_f, feats), (got_l, logits)):
        assert torch.linalg.norm(got - want) <= BF16_RTOL * torch.linalg.norm(want)

