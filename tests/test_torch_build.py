"""``kernels/build.py::launch`` calls the kernel's library with the tensor's
device as the current CUDA device (a stream of one card behind another
card's context is an invalid handle), on that device's current stream,
and counts only launches the runtime took. The CUDA calls are replaced by
fakes that record what the library saw, so this runs on the CPU."""

import contextlib

import pytest
import torch

from myyuv_tpu_torch.kernels import build


@pytest.fixture
def fake_cuda(monkeypatch):
    """Fakes of torch.cuda.device, torch.cuda.current_stream and
    build.load; returns the record of the library's calls."""
    state = {"current": torch.device("cuda", 0), "calls": [], "rc": 0}

    @contextlib.contextmanager
    def device(dev):
        before = state["current"]
        state["current"] = torch.device(dev)
        try:
            yield
        finally:
            state["current"] = before

    class Stream:
        def __init__(self, dev):
            self.cuda_stream = 1000 + torch.device(dev).index

    def library(*args):
        state["calls"].append((state["current"], args))
        return state["rc"]

    monkeypatch.setattr(torch.cuda, "device", device)
    monkeypatch.setattr(torch.cuda, "current_stream", Stream)
    monkeypatch.setattr(build, "load", lambda name: library)
    monkeypatch.setitem(build.launches, "dct_encode",
                        build.launches["dct_encode"])
    return state


@pytest.mark.parametrize("index", [0, 1, 3])
def test_launch_makes_the_device_current(fake_cuda, index):
    dev = torch.device("cuda", index)
    before = build.launches["dct_encode"]
    build.launch("dct_encode", dev, 11, 22)
    assert fake_cuda["calls"] == [(dev, (11, 22, 1000 + index))]
    assert fake_cuda["current"] == torch.device("cuda", 0)   # restored
    assert build.launches["dct_encode"] == before + 1


def test_refused_launch_raises_and_is_not_counted(fake_cuda):
    fake_cuda["rc"] = 400
    before = build.launches["dct_encode"]
    with pytest.raises(RuntimeError, match="CUDA error 400"):
        build.launch("dct_encode", torch.device("cuda", 1), 5)
    assert fake_cuda["calls"][0][0] == torch.device("cuda", 1)
    assert fake_cuda["current"] == torch.device("cuda", 0)
    assert build.launches["dct_encode"] == before
