"""``serve/host_frames.py``: which host buffers are page-locked in place,
on a stand-in for the CUDA runtime (every test but the last two, which
need a card), and on the card, that an upload is exact whichever way it
goes and leaves the caller's buffer free to be written when it returns."""

import gc
import weakref

import numpy as np
import pytest
import torch

from facerec_torch.serve import host_frames
from facerec_torch.serve.host_frames import HostFrames

MIB = 1 << 20


class FakeRuntime:
    """``torch.cuda.cudart()``'s two calls, recorded; ``refuse`` is the error
    code every registration returns."""

    def __init__(self, refuse: int = 0):
        self.refuse = refuse
        self.registered: dict[int, int] = {}
        self.calls: list[tuple] = []

    def cudaHostRegister(self, ptr, size, flags):
        self.calls.append(("register", ptr, size, flags))
        if self.refuse:
            return self.refuse
        self.registered[ptr] = size
        return 0

    def cudaHostUnregister(self, ptr):
        self.calls.append(("unregister", ptr))
        return 0 if self.registered.pop(ptr, None) is not None else 713


@pytest.fixture
def rt(monkeypatch):
    fake = FakeRuntime()
    monkeypatch.setattr(torch.cuda, "cudart", lambda: fake)
    return fake


@pytest.fixture
def frames(rt):
    """HostFrames on the stand-in runtime, let go after the test."""
    made = []

    def make():
        made.append(HostFrames(torch.device("cuda")))
        return made[-1]

    yield make
    made.clear()
    gc.collect()  # let them go while the stand-in runtime is in place


def _buf(mib: int = 2) -> np.ndarray:
    return np.zeros((mib, MIB), dtype=np.uint8)


def _registered(hf: HostFrames) -> int:
    return sum(n for _, n in hf._held)


def test_a_buffer_is_registered_at_its_second_upload(rt, frames):
    hf, a = frames(), _buf()
    assert not hf._register(a)
    assert rt.calls == []
    assert hf._register(a)
    assert rt.calls == [("register", a.ctypes.data, a.nbytes, 0)]
    assert _registered(hf) == a.nbytes


def test_buffers_used_in_turn_are_each_registered(rt, frames):
    hf, a, b = frames(), _buf(), _buf()
    assert [hf._register(x) for x in (a, b, a, b)] == [False, False, True, True]
    assert set(rt.registered) == {a.ctypes.data, b.ctypes.data}


def test_a_fresh_array_each_upload_is_never_registered(rt, frames):
    hf, a = frames(), _buf()
    assert not any(hf._register(a.copy()) for _ in range(6))
    assert rt.calls == []


def test_another_array_at_a_remembered_address_starts_over(rt, frames):
    hf, a = frames(), _buf()
    key = (a.ctypes.data, a.nbytes)
    hf._register(a)
    hf._seen[key] = weakref.ref(_buf())  # as if another owner had brought that address
    assert not hf._register(a)
    assert hf._register(a)


def test_small_and_foreign_buffers_are_staged(rt, frames):
    hf = frames()
    small = np.zeros(MIB // 2, dtype=np.uint8)
    foreign = np.frombuffer(bytearray(2 * MIB), dtype=np.uint8)  # owned by a bytearray
    for x in (small, small, foreign, foreign):
        assert not hf._register(x)
    assert rt.calls == []


def test_views_register_their_own_range_and_an_overlap_is_refused(rt, frames):
    hf, a = frames(), _buf(4)
    first, overlapping, apart = a[:2], a[1:3], a[2:4]
    assert [hf._register(first), hf._register(first)] == [False, True]
    assert [hf._register(overlapping), hf._register(overlapping)] == [False, False]
    assert [hf._register(apart), hf._register(apart)] == [False, True]
    assert sorted(rt.registered.items()) == [(first.ctypes.data, 2 * MIB),
                                             (apart.ctypes.data, 2 * MIB)]


def test_no_more_than_max_bytes_are_registered(rt, frames, monkeypatch):
    monkeypatch.setattr(host_frames, "MAX_BYTES", 3 * MIB)
    hf, a, b = frames(), _buf(), _buf()
    assert [hf._register(x) for x in (a, a, b, b)] == [False, True, False, False]
    assert _registered(hf) == 2 * MIB


def test_a_refused_registration_clears_the_error_and_ends_registering(rt, frames, monkeypatch):
    cleared = []
    monkeypatch.setattr(host_frames, "_clear_cuda_error", lambda: cleared.append(1))
    rt.refuse = 712  # cudaErrorHostMemoryAlreadyRegistered
    hf, a, b = frames(), _buf(), _buf()
    assert [hf._register(x) for x in (a, a, b, b, a, a)] == [False] * 6
    assert [c[0] for c in rt.calls] == ["register"]
    assert cleared == [1]


def test_a_registered_buffer_is_held_until_it_is_unregistered(rt):
    hf, a = HostFrames(torch.device("cuda")), _buf()
    ptr, ref = a.ctypes.data, weakref.ref(a)
    hf._register(a)
    hf._register(a)
    del a
    gc.collect()
    assert ref() is not None  # CUDA still has its pages locked
    del hf
    gc.collect()
    assert ref() is None
    assert rt.calls[-1] == ("unregister", ptr) and rt.registered == {}


def test_letting_go_unregisters_every_buffer(rt):
    hf, a, b = HostFrames(torch.device("cuda")), _buf(), _buf()
    for x in (a, b, a, b):
        hf._register(x)
    del hf
    gc.collect()
    assert rt.registered == {}
    assert sorted(c[1] for c in rt.calls if c[0] == "unregister") == sorted(
        [a.ctypes.data, b.ctypes.data])


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: page-locking host memory needs CUDA")
    return torch.device("cuda")


@pytest.mark.cuda
def test_card_upload_is_exact_and_returns_the_buffer_free(dev):
    hf = HostFrames(dev)
    rng = np.random.default_rng(3)
    buf = rng.integers(0, 255, (8, 480, 640, 3), dtype=np.uint8)
    for i in range(4):
        buf[0, 0, 0, 0] = i
        want = buf.copy()
        torch.cuda._sleep(20_000_000)  # work queued ahead of the upload
        x = hf.upload(buf)
        buf[:] = 7  # the caller writes its buffer again at once
        assert torch.equal(x.cpu(), torch.from_numpy(want)), i
        buf[:] = want
    assert _registered(hf) == buf.nbytes
    assert torch.from_numpy(buf).is_pinned()
    del hf
    gc.collect()
    assert not torch.from_numpy(buf).is_pinned()


@pytest.mark.cuda
def test_card_pipeline_upload_registers_a_reused_batch_and_matches_the_staged_one(dev):
    from facerec_torch.config import ServeConfig
    from facerec_torch.serve.pipeline import FacePipeline

    pipe = FacePipeline(ServeConfig(gallery_capacity=8), (480, 640), None, None, device=dev)
    rng = np.random.default_rng(4)
    batch = rng.integers(0, 255, (16, 480, 640, 3), dtype=np.uint8)
    staged = [pipe.upload(batch.copy()) for _ in range(2)]  # a fresh array each time
    assert _registered(pipe._host_frames) == 0
    reused = [pipe.upload(batch) for _ in range(3)]
    assert _registered(pipe._host_frames) == batch.nbytes
    for x in staged + reused:
        assert x.dtype == torch.uint8 and x.device.type == "cuda"
        assert torch.equal(x, staged[0])
    floats = pipe.upload(batch.astype(np.float64))
    assert floats.dtype == torch.float32 and torch.equal(floats, staged[0].float())
