"""At tiny widths on the CPU, the plain reference's I3D, RAFT and PWC agree
with the port's modules given the same weights. (This test imports both;
the reference itself imports nothing of the port.)"""

import copy

import pytest
import torch

from port_bench.harness import spec
from port_bench.harness.inputs import fill
from port_bench.reference.i3d import I3D as RefI3D
from port_bench.reference.pipeline import replicate_pad8
from port_bench.reference.pwc import PWCNet as RefPWC
from port_bench.reference.raft import RAFT as RefRAFT


def _weights(model, seed):
    with torch.device("meta"):
        meta = copy.deepcopy(model)
    return fill(meta, seed, "cpu").state_dict()


def _close(got, ref, tol):
    err = (got - ref).norm() / ref.norm()
    assert err < tol, float(err)


@pytest.mark.parametrize("channels", [3, 2])
def test_i3d(channels):
    from video_features_tpu_torch.models.i3d.model import I3D

    sizes = spec.config("i3d_raft")["sizes"]["i3d"]
    with torch.device("meta"):
        ref = RefI3D(channels, sizes, width_div=16)
    ref = fill(ref, 1, "cpu")
    port = I3D(channels, channel_div=16).eval()
    port.load_state_dict(ref.state_dict())
    x = torch.rand(1, 16, 224, 224, channels, generator=torch.Generator().manual_seed(0)) * 2 - 1
    with torch.no_grad():
        got, _ = port(x)
        want = ref(x.permute(0, 4, 1, 2, 3))
    _close(got, want, 1e-5)


def test_raft():
    from video_features_tpu_torch.models.raft.model import RAFT

    sizes = dict(spec.config("i3d_raft")["sizes"]["raft"], iters=3)
    with torch.device("meta"):
        ref = RefRAFT(sizes)
    ref = fill(ref, 2, "cpu")
    port = RAFT(iters=3).eval()
    port.load_state_dict({k: v for k, v in ref.state_dict().items() if ".norm3." not in k})
    frames = torch.rand(3, 128, 132, 3, generator=torch.Generator().manual_seed(1)) * 255
    with torch.no_grad():
        want = ref(replicate_pad8(frames.permute(0, 3, 1, 2)))
        from video_features_tpu_torch.models.raft.extract_raft import InputPadder

        got = port(InputPadder((128, 132)).pad_tensor(frames)).permute(0, 3, 1, 2)
    _close(got, want, 1e-4)


def test_pwc():
    from video_features_tpu_torch.models.pwc.model import PWCNet

    with torch.device("meta"):
        ref = RefPWC(spec.config("i3d_pwc")["sizes"]["pwc"])
    ref = fill(ref, 3, "cpu")
    port = PWCNet(corr_method="plain").eval()
    port.load_state_dict(ref.state_dict())
    frames = torch.rand(3, 64, 90, 3, generator=torch.Generator().manual_seed(2)) * 255
    with torch.no_grad():
        want = ref.estimate(frames.permute(0, 3, 1, 2))
        got = port(frames).permute(0, 3, 1, 2)
    _close(got, want, 1e-5)
