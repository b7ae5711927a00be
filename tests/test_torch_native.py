"""The port's native frame pump (``cudacam_tpu_torch/native``): every case of
``tests/test_native.py`` through the port (the build, the rawv round trip,
zero-copy acquire, looping, the ring depth, the bad inputs, the
``RawvSource`` contract, ``open_source`` dispatch, the app on a rawv on
``device="cpu"``, the cross-thread stop / close contract), then what the
port adds: the build into ``cudacam_tpu_torch/_build``, ``write_rawv``'s
bytes against ``io/rawv.py`` and the JAX package's native writer, slots lent
and given back oldest first, and the raises on a failed build, on pinning
without a card and on an upload from a slot that is not pinned. The pinned
upload itself runs on the card (``tests/test_torch_cuda.py``).
"""
from __future__ import annotations

import shutil
import threading
import time

import numpy as np
import pytest

from cudacam_tpu_torch import native
from cudacam_tpu_torch.io import rawv
from cudacam_tpu_torch.io.sources import make_scene

pytestmark = pytest.mark.skipif(shutil.which("g++") is None, reason="no C++ toolchain")


@pytest.fixture(scope="module")
def lib():
    return native.load_library()


@pytest.fixture()
def rawv_file(tmp_path, lib):
    frames = np.stack([make_scene(32, 48, seed=s) for s in range(6)])
    p = str(tmp_path / "clip.rawv")
    native.write_rawv(p, frames)
    return p, frames


class TestFramePump:
    def test_header_and_roundtrip(self, rawv_file):
        path, frames = rawv_file
        with native.FramePump(path) as pump:
            assert (pump.height, pump.width, pump.channels) == (32, 48, 3)
            assert pump.n_frames == 6
            got = []
            while True:
                f = pump.read()
                if f is None:
                    break
                got.append(f)
        assert len(got) == 6
        for a, b in zip(got, frames):
            np.testing.assert_array_equal(a, b)

    def test_zero_copy_acquire(self, rawv_file):
        path, frames = rawv_file
        with native.FramePump(path) as pump:
            v0 = pump.acquire()
            assert v0 is not None and not v0.flags.writeable
            np.testing.assert_array_equal(v0, frames[0])
            v1 = pump.acquire()  # gives slot 0 back
            np.testing.assert_array_equal(v1, frames[1])
            assert pump.lent == 1

    def test_loop_mode(self, rawv_file):
        path, frames = rawv_file
        with native.FramePump(path, loop=True) as pump:
            got = [pump.read() for _ in range(8)]
        np.testing.assert_array_equal(got[6], frames[0])
        np.testing.assert_array_equal(got[7], frames[1])

    def test_prefetch_fills_ring(self, rawv_file):
        path, _ = rawv_file
        with native.FramePump(path, ring_slots=3) as pump:
            deadline = time.time() + 2.0
            while pump.buffered < 3 and time.time() < deadline:
                time.sleep(0.01)
            assert pump.buffered == 3  # producer ran ahead without consumer

    def test_mono_stream(self, tmp_path):
        frames = np.random.default_rng(0).integers(0, 256, (4, 16, 24), dtype=np.uint8)
        p = str(tmp_path / "mono.rawv")
        native.write_rawv(p, frames)
        with native.FramePump(p) as pump:
            assert pump.channels == 1
            np.testing.assert_array_equal(pump.read(), frames[0])

    def test_bad_file_rejected(self, tmp_path):
        p = str(tmp_path / "junk.rawv")
        with open(p, "wb") as f:
            f.write(b"not a rawv stream")
        with pytest.raises(IOError):
            native.FramePump(p)

    def test_write_rejects_bad_input(self, tmp_path):
        with pytest.raises(ValueError):
            native.write_rawv(str(tmp_path / "x.rawv"), np.zeros((2, 4, 4), np.float32))


class TestRawvSource:
    def test_source_contract(self, rawv_file):
        from cudacam_tpu_torch.io.sources import RawvSource

        path, frames = rawv_file
        with RawvSource(path) as src:
            assert src.spec == (32, 48, 3)
            got = list(src)
        assert len(got) == 6
        np.testing.assert_array_equal(got[3], frames[3])

    def test_open_source_dispatch(self, rawv_file):
        from cudacam_tpu_torch.io import open_source
        from cudacam_tpu_torch.io.sources import RawvSource

        path, _ = rawv_file
        assert isinstance(open_source(path), RawvSource)
        assert isinstance(open_source(f"rawv:{path}"), RawvSource)

    def test_app_runs_on_rawv(self, rawv_file):
        from cudacam_tpu_torch.app import CannyApp
        from cudacam_tpu_torch.io.sources import RawvSource

        path, _ = rawv_file
        with CannyApp(RawvSource(path), device="cpu") as app:
            n = app.run(None)  # until EOF
            assert n == 6
            out = app.ring.latest_np()
            assert out.shape == (32, 48) and out.dtype == np.uint8


class TestShutdownContract:
    """fp_stop / fp_close threading contract (framepump.cpp): a consumer
    blocked in acquire() is woken by a cross-thread stop() and the
    subsequent close() must not touch freed state."""

    def test_cross_thread_stop_unblocks_acquire(self, tmp_path):
        frames = np.zeros((2, 8, 8), np.uint8)
        path = native.write_rawv(str(tmp_path / "s.rawv"), frames)
        pump = native.FramePump(path, ring_slots=2)
        pump.close()

        pump = native.FramePump(path, loop=True, ring_slots=2)
        seen = []

        def consumer():
            while True:
                v = pump.acquire()
                if v is None:
                    break
                seen.append(1)
                if len(seen) >= 8:
                    time.sleep(0.05)  # let the ring refill, then block

        t = threading.Thread(target=consumer)
        t.start()
        time.sleep(0.2)
        pump.stop()  # cross-thread: must wake the blocked acquire
        t.join(timeout=5)
        assert not t.is_alive()
        assert len(seen) >= 8
        pump.close()  # owner thread destroys after consumer exited

    def test_stop_idempotent_and_close_after_stop(self, tmp_path):
        path = native.write_rawv(str(tmp_path / "t.rawv"), np.zeros((1, 4, 4), np.uint8))
        pump = native.FramePump(path, ring_slots=2)
        pump.stop()
        pump.stop()
        pump.close()


# -- what the port adds -------------------------------------------------------


def test_builds_into_the_ports_build_directory(lib):
    path = native.library_path()
    assert path.parent == native.BUILD_DIR and path.parent.name == "_build"
    assert path.parent.parent.name == "cudacam_tpu_torch" and path.exists()


@pytest.mark.parametrize("shape", [(3, 17, 23, 3), (2, 9, 31), (1, 1, 1, 3)])
def test_write_rawv_bytes(tmp_path, shape):
    """The native writer's bytes: ``io/rawv.py``'s and the JAX package's
    native writer's."""
    from cudacam_tpu.native import write_rawv as jax_write_rawv

    frames = np.random.default_rng(1).integers(0, 256, shape, dtype=np.uint8)
    native.write_rawv(str(tmp_path / "n.rawv"), frames)
    rawv.write_rawv(str(tmp_path / "p.rawv"), frames)
    jax_write_rawv(str(tmp_path / "j.rawv"), frames)
    got = (tmp_path / "n.rawv").read_bytes()
    assert got == (tmp_path / "p.rawv").read_bytes() == (tmp_path / "j.rawv").read_bytes()


def test_lend_keeps_older_slots_and_gives_back_oldest_first(rawv_file):
    path, frames = rawv_file
    with native.FramePump(path, ring_slots=3) as pump:
        views = [pump.lend() for _ in range(3)]
        assert pump.lent == 3
        for v, f in zip(views, frames):
            np.testing.assert_array_equal(v, f)
        pump.give_back()  # slot of frame 0
        views.append(pump.lend())  # frame 3 into that slot
        for v, f in zip(views[1:], frames[1:4]):
            np.testing.assert_array_equal(v, f)  # frames 1, 2 untouched
        assert pump.lent == 3
        np.testing.assert_array_equal(pump.read(), frames[4])  # gives back all three first
        assert pump.lent == 0
        with pytest.raises(RuntimeError, match="no slot is lent"):
            pump.give_back()


def test_lend_at_end_of_stream(rawv_file):
    path, frames = rawv_file
    with native.FramePump(path, ring_slots=4) as pump:
        views = [pump.lend() for _ in range(4)]
        for _ in range(4):
            pump.give_back()
        rest = [pump.lend(), pump.lend()]
        np.testing.assert_array_equal(rest[1], frames[5])
        assert pump.lend() is None and pump.lent == 2
        del views


def test_copying_read_refused_while_slots_are_lent(rawv_file, lib):
    path, frames = rawv_file
    with native.FramePump(path) as pump:
        pump.lend()
        dst = np.empty(frames[0].shape, np.uint8)
        assert lib.fp_read(pump._h, dst.ctypes.data_as(native._U8P)) == -1
        pump.give_back()
        assert lib.fp_read(pump._h, dst.ctypes.data_as(native._U8P)) == 1
        np.testing.assert_array_equal(dst, frames[1])


def test_slots_are_page_aligned(rawv_file):
    path, frames = rawv_file
    with native.FramePump(path, ring_slots=3) as pump:
        slots = pump.slots()
    assert len(slots) == 3 and len({a for a, _ in slots}) == 3
    assert all(a % 4096 == 0 and n == frames[0].nbytes for a, n in slots)


def test_rawv_source_lends_slots(rawv_file):
    from cudacam_tpu_torch.io.sources import RawvSource

    path, frames = rawv_file
    with RawvSource(path, ring_slots=3) as src:
        assert src.lent == 1  # the first frame, held since start()
        a, b = src.lend(), src.lend()
        assert src.lent == 2 and not a.flags.writeable
        with pytest.raises(RuntimeError, match="slots are lent"):
            src.read()
        np.testing.assert_array_equal(a, frames[0])
        np.testing.assert_array_equal(b, frames[1])
        src.give_back()
        src.give_back()
        np.testing.assert_array_equal(src.read(), frames[2])
        assert src.lent == 0


def test_pinning_without_a_card_raises(rawv_file, monkeypatch):
    import torch

    from cudacam_tpu_torch.io.sources import RawvSource

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    path, _ = rawv_file
    with native.FramePump(path) as pump:
        with pytest.raises(RuntimeError, match="needs a CUDA device"):
            pump.pin()
        assert not pump.pinned
    with RawvSource(path) as src, pytest.raises(RuntimeError, match="needs a CUDA device"):
        src.pin()


def test_upload_from_an_unpinned_slot_raises(rawv_file):
    """The slot route never uploads from pageable memory: on an unpinned
    slot the app raises instead of a copy that would be synchronous."""
    from cudacam_tpu_torch.app import CannyApp
    from cudacam_tpu_torch.io.sources import RawvSource

    path, _ = rawv_file
    with CannyApp(RawvSource(path), device="cpu") as app:
        assert not app._lends  # the CPU engine takes the frames as they come
        app._lends = True
        with pytest.raises(RuntimeError, match="not pinned"):
            app.step()
        app._lends = False  # no stream to wait for on the CPU


def test_failed_build_raises(tmp_path, monkeypatch):
    bad = tmp_path / "framepump.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "_build")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.load_library.__wrapped__()
    monkeypatch.setattr(native.shutil, "which", lambda _: None)
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        native.load_library.__wrapped__()


@pytest.fixture()
def stub_slot_route(monkeypatch):
    """The app's slot route without a card: its upload the CPU's no-op,
    pinning and events stubbed (an app sets ``_lends`` itself)."""
    import torch

    class Event:
        def record(self, stream):
            pass

        def query(self):
            return True

        def synchronize(self):
            pass

    monkeypatch.setattr(torch.cuda, "Event", Event)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev: Event())
    monkeypatch.setattr(torch.Tensor, "is_pinned", lambda self: True)


@pytest.mark.parametrize("ring_slots", [1, 2, 4])
def test_slot_route_bookkeeping(rawv_file, stub_slot_route, ring_slots):
    """The app's slot route without a card: slots go back oldest first,
    never more are lent than the ring holds (no deadlock at one or two
    slots), the newest stays lent as the current raw frame (pause re-uploads
    it), and closing gives every slot back. The edge maps equal the engine's
    on the file's frames."""
    import torch

    from cudacam_tpu_torch.app import CannyApp
    from cudacam_tpu_torch.engine import CannyEngine
    from cudacam_tpu_torch.io.sources import RawvSource

    path, frames = rawv_file
    src = RawvSource(path, ring_slots=ring_slots)
    with CannyApp(src, device="cpu") as app:
        app._lends = True
        eng = CannyEngine(app._cfg, device="cpu")
        lent, outs = [], []
        done = app.run(None, on_frame=lambda i, o: (lent.append(src.lent), outs.append(o.clone())))
        # one slot: the newest goes back before the next lend (EOF here)
        assert done == 6 and max(lent) <= ring_slots and src.lent == (ring_slots > 1)
        for out, f in zip(outs, frames):
            assert torch.equal(out, eng.process(f))
        np.testing.assert_array_equal(app._last_input, frames[-1])
        app.pause()
        assert torch.equal(app.step(), outs[-1])
    assert src.lent == 0


@pytest.mark.parametrize("ring_slots", [1, 2, 4])
def test_slot_route_raw_frame_outlives_its_slot(rawv_file, stub_slot_route, tmp_path, ring_slots):
    """The current raw frame is copied before its slot goes back: after the
    stream ends and after ``close`` (which frees the slots), ``_last_input``
    is an owned copy of the last frame, and ``preview`` / ``save_frame``
    show what they showed while the slot was lent."""
    from cudacam_tpu_torch.app import CannyApp
    from cudacam_tpu_torch.io.sources import RawvSource

    path, frames = rawv_file
    with CannyApp(RawvSource(path, ring_slots=ring_slots), device="cpu") as app:
        app._lends = True
        held = []
        app.run(None, on_frame=lambda i, o: held.append(app._last_input))
        assert all(v.base is not None for v in held)  # on_frame sees the lent views
        before = app.preview(width=24), open(app.save_frame(str(tmp_path / "a.png")), "rb").read()
    assert app._last_input.base is None and app._last_input.flags.writeable
    np.testing.assert_array_equal(app._last_input, frames[-1])
    after = app.preview(width=24), open(app.save_frame(str(tmp_path / "b.png")), "rb").read()
    assert after == before


def test_rawv_source_frame_never_holds_a_lent_view(rawv_file):
    """``RawvSource.frame`` keeps only ``read()``'s owned copies: a lent view
    would point into a slot the producer refills."""
    from cudacam_tpu_torch.io.sources import RawvSource

    path, frames = rawv_file
    with RawvSource(path, ring_slots=2) as src:
        assert src.frame is None
        src.lend()
        src.lend()
        assert src.frame is None
        src.give_back()
        src.give_back()
        got = src.read()
        assert src.frame is got and got.base is None
        np.testing.assert_array_equal(got, frames[2])
