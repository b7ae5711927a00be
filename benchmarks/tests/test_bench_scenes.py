"""The torch scene recipes against the system's NumPy originals, and the
inputs a run makes from its seed."""
import numpy as np
import pytest
import torch

from benchmarks import scenes
from cudacam_tpu_torch.io import sources


@pytest.mark.parametrize("h, w, seed, t", [(96, 128, 0, 0.0), (120, 200, 3, 5.0),
                                           (64, 64, 7, 2.0), (200, 333, 11, 15.0)])
def test_scene_is_the_original_scene(h, w, seed, t):
    """Given the original's own noise draw, the torch scene is byte-equal."""
    layout = scenes.scene_layout(h, w, seed)
    noise = torch.from_numpy(layout.rng.normal(0, 2.0, size=(h, w, 3)))
    got = scenes.make_scene(h, w, seed, t, "cpu", noise=noise).numpy()
    np.testing.assert_array_equal(got, sources.make_scene(h, w, seed, t))


@pytest.mark.parametrize("h, w", [(28, 28), (96, 128), (131, 77), (200, 333)])
def test_spiral_is_the_original_spiral(h, w):
    got = scenes.make_spiral_frame(h, w, "cpu").numpy()
    np.testing.assert_array_equal(got, sources.make_spiral_frame(h, w))


def test_scene_noise_follows_the_generator():
    def draw(seed):
        g = torch.Generator().manual_seed(seed)
        return scenes.make_scene(64, 96, 1, 0.0, "cpu", generator=g)

    assert torch.equal(draw(5), draw(5))
    assert not torch.equal(draw(5), draw(6))
    assert (draw(5).int() - draw(6).int()).abs().max() <= 40  # noise only


def _traffic(**kw):
    d = dict(scenes=2, times=3, batch=4, batched=True, in_flight=8, check_calls=2,
             spirals_per_call=1)
    d.update(kw)
    return scenes.Traffic.from_dict(d)


def test_every_seed_runs_the_same_frames_in_another_order():
    """The frames are fixed, since their content sets their work; the seed
    draws the order of the calls and the spiral's slots."""
    t = _traffic()
    a, b = (scenes.make_inputs(t, 64, 96, 2**31 + 7, "cpu") for _ in range(2))
    assert torch.equal(a.sources, b.sources) and a.slots == b.slots and a.order == b.order
    others = [scenes.make_inputs(t, 64, 96, s, "cpu") for s in (11, 12, 13)]
    assert all(torch.equal(a.sources, o.sources) for o in others)
    assert any(o.order != a.order or o.slots != a.slots for o in others)
    assert all(sorted(map(sorted, o.slots)) == sorted(map(sorted, a.slots)) for o in others)


def test_scene_frames_differ_in_time_and_scene():
    t = _traffic()
    inp = scenes.make_inputs(t, 64, 96, 1, "cpu")
    n = t.scenes * t.times
    assert len({bytes(inp.sources[k].numpy()) for k in range(n)}) == n


def test_calls_take_every_calm_frame_and_a_spiral_each():
    t = _traffic()
    inp = scenes.make_inputs(t, 64, 96, 3, "cpu")
    n_calm = t.scenes * t.times
    assert len(inp.calls) == -(-n_calm // (t.batch - 1))
    for call, slot in zip(inp.calls, inp.slots):
        assert call.shape == (t.batch, 64, 96, 3)
        assert slot.count(n_calm) == 1
        for k, src in enumerate(slot):
            assert torch.equal(call[k], inp.sources[src])
    assert {s for slot in inp.slots for s in slot} == set(range(n_calm + 1))
    assert sorted(inp.order) == list(range(len(inp.calls)))


def test_single_frame_calls_are_views_of_the_pool():
    t = _traffic(batch=1, batched=False, spirals_per_call=0)
    inp = scenes.make_inputs(t, 64, 96, 3, "cpu")
    assert len(inp.calls) == 6 and all(c.shape == (64, 96, 3) for c in inp.calls)
    assert all(c.data_ptr() == inp.sources[s[0]].data_ptr() for c, s in zip(inp.calls, inp.slots))


def test_bad_traffic_is_refused():
    with pytest.raises(ValueError):
        _traffic(batch=2, batched=False, spirals_per_call=0)
    with pytest.raises(ValueError):
        _traffic(in_flight=0)
