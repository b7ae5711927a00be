"""The port's threshold sweep on the CPU against the JAX package: the
monotone-seeded ``sweep_fused`` (K5) against the Pallas kernel in interpret
mode, on a spiral cut off by the round cap and on converged inputs;
``threshold_sweep`` against ``threshold_sweep_pallas`` (interpret mode) and
``xla_ops.threshold_sweep``; ``CannyEngine.threshold_sweep``; the CLI's
``sweep`` and ``info``.

Tolerance: 0. Edge maps and counts are integers, and the contract is byte
equality, maps cut off by the cap included (with the same seeding).
"""
from __future__ import annotations

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cudacam_tpu import CannyConfig
from cudacam_tpu.io.sources import make_scene, make_spiral_thresh
from cudacam_tpu.ops import xla_ops
from cudacam_tpu.ops.pallas import hysteresis_fused as jhf
from cudacam_tpu.ops.pallas.canny import threshold_sweep_pallas
from cudacam_tpu_torch.cli import main as cli_main
from cudacam_tpu_torch.engine import CannyEngine
from cudacam_tpu_torch.state import config_from_jax
from cudacam_tpu_torch.ops import torch_ops
from cudacam_tpu_torch.ops.cuda import canny as tcanny
from cudacam_tpu_torch.ops.cuda import hysteresis_fused as thf
from cudacam_tpu_torch.ops.cuda.megakernel import unpack, unpack_plain

torch.set_num_threads(2)

H, W = 64, 256
#: Shuffled pairs: negative lows (-1 and -3 clamp to a 0 bound), an exact
#: duplicate (20, 60), a pair that dominates nothing before it.
LOWS = [20, -1, 5, -3, 20, 10]
HIGHS = [60, 40, 40, 30, 60, 25]


@pytest.fixture(scope="module")
def spiral_kg():
    """A 64x128 spiral as a keep*g plane: 3 at the seed, 2 along the chain."""
    t = make_spiral_thresh(64, 128)
    return np.where(t == 255, 3, np.where(t == 128, 2, 0)).astype(np.int32)


def _both(kg, bounds, **kw):
    got = thf.sweep_fused(torch.from_numpy(kg), torch.from_numpy(np.int32(bounds)), **kw)
    want = jhf.sweep_fused(jnp.asarray(kg), jnp.asarray(np.int32(bounds)), interpret=True, **kw)
    return got.numpy(), np.asarray(want)


@pytest.mark.parametrize("max_iters,scan_after,seeded,cold", [
    (4, 100, [5, 9, 13], [5, 5, 5]),            # phase 1 cut off
    (6, 2, [738, 1410, 2018], [738, 738, 738]),  # phase 2 cut off
])
@pytest.mark.parametrize("monotone_seed", [True, False])
def test_spiral_cut_off_by_the_cap(spiral_kg, max_iters, scan_after, seeded, cold,
                                   monotone_seed):
    """Seeding changes maps cut off by the cap: each duplicate pair goes on
    from its predecessor's truncated plane. The port's maps are the JAX
    kernel's in both modes."""
    got, want = _both(spiral_kg, [1, 2, 1, 2, 0, 2], max_iters=max_iters, dilate_steps=1,
                      scan_after=scan_after, monotone_seed=monotone_seed)
    np.testing.assert_array_equal(got, want)
    assert (got == 255).sum((1, 2)).tolist() == (seeded if monotone_seed else cold)


def test_spiral_converged_seeded_equals_cold(spiral_kg):
    kw = dict(max_iters=100, dilate_steps=1, scan_after=2)
    got, want = _both(spiral_kg, [1, 2, 1, 2, 0, 2], monotone_seed=True, **kw)
    np.testing.assert_array_equal(got, want)
    cold = thf.sweep_fused(torch.from_numpy(spiral_kg), torch.tensor([1, 2, 1, 2, 0, 2],
                           dtype=torch.int32), monotone_seed=False, **kw)
    np.testing.assert_array_equal(got, cold.numpy())
    assert (got == 255).sum((1, 2)).tolist() == [4097] * 3


@pytest.mark.parametrize("bounds,finals", [
    ([0, 2, 1, 2, 1, 2], [13, 5, 9]),
    ([-5, 2, -1, 2, 0, 1, 1, 2], [9, 13, 4097, 5]),  # -5 and -1 clamp into a duplicate
])
def test_duplicates_keep_ascending_index(spiral_kg, bounds, finals):
    """Exact duplicates (after the clamp at 0) run in ascending original
    index, so the same index gets the same truncated map as in JAX."""
    got, want = _both(spiral_kg, bounds, max_iters=4, dilate_steps=1, scan_after=100,
                      monotone_seed=True)
    np.testing.assert_array_equal(got, want)
    assert (got == 255).sum((1, 2)).tolist() == finals
    b = np.int32(bounds).clip(0).reshape(-1, 2)
    order = thf.sweep_order(torch.from_numpy(np.int32(bounds)))
    assert order.tolist() == np.lexsort((-b[:, 1], -b[:, 0])).tolist()


def test_sweep_launch_sequence_on_the_cpu(spiral_kg, monkeypatch):
    """The kernels' launch sequence, every step on its plain version here,
    equals the plain sweep: one ``sweep_pack_all``, then per slot its seed
    (from the second slot on, seeded only) and its rounds; so does the
    indexed unpack its plain form."""
    kg = torch.from_numpy(spiral_kg)
    bounds = torch.tensor([0, 2, 1, 2, 1, 2, 2, 3], dtype=torch.int32)
    kw = dict(max_iters=6, dilate_steps=1, scan_after=2)
    for seed in (True, False):
        calls = []
        for name in ("sweep_pack_all", "sweep_seed", "converge"):
            fn = getattr(thf, name)
            monkeypatch.setattr(thf, name, lambda *a, _fn=fn, _n=name, **k: (
                calls.append(_n), _fn(*a, **k))[1])
        got = thf._sweep_launches(kg, bounds, 4, monotone_seed=seed, **kw)
        monkeypatch.undo()
        assert torch.equal(got, thf.sweep_fused_plain(kg, bounds, monotone_seed=seed, **kw))
        step = ["sweep_seed", "converge"] if seed else ["converge"]
        assert calls == ["sweep_pack_all", "converge"] + step * 3
    f = torch.from_numpy(np.random.default_rng(1).integers(-2**31, 2**31 - 1, (3, 2, 53),
                                                           dtype=np.int32))
    index = torch.tensor([2, 0, 1], dtype=torch.int32)
    out = unpack(f, 37, index)
    assert torch.equal(out[index.long()], unpack_plain(f, 37))
    with pytest.raises(ValueError):
        unpack(f[0], 37, index)  # an index needs a batch of planes


def test_sweep_pack_seeds_only_from_a_dominating_pair():
    """Every slot's planes from ``sweep_pack_all``, unseeded; then
    ``sweep_seed`` ORs a slot's FINAL plane with the one before only where
    that pair dominates: (200, 250) vs (100, 260) does not, (100, 260) vs
    (-7 -> 0, 150) does."""
    rng = np.random.default_rng(2)
    kg = torch.from_numpy(rng.integers(0, 300, (40, 70), dtype=np.int32))
    bounds = torch.tensor([200, 250, 100, 260, -7, 150], dtype=torch.int32)
    f = torch.from_numpy(rng.integers(-2**31, 2**31 - 1, (3, 2, 70), dtype=np.int32))
    p = torch.zeros_like(f)
    thf.sweep_pack_all(kg, bounds, f, p)
    for slot in range(3):
        lo, hi = max(int(bounds[2 * slot]), 0), int(bounds[2 * slot + 1])
        assert torch.equal(thf.bitpack.unpack_mask(f[slot], 40), kg > hi)
        assert torch.equal(thf.bitpack.unpack_mask(p[slot], 40), (kg > lo) & (kg <= hi))
    prior = torch.from_numpy(rng.integers(-2**31, 2**31 - 1, (2, 70), dtype=np.int32))
    for slot, seeded in ((1, False), (2, True)):
        g = f.clone()
        g[slot - 1] = prior
        thf.sweep_seed(bounds, slot, g)
        hi = int(bounds[2 * slot + 1])
        expect = kg > hi
        if seeded:
            expect |= thf.bitpack.unpack_mask(prior, 40)
        assert torch.equal(thf.bitpack.unpack_mask(g[slot], 40), expect)
        assert torch.equal(g[slot - 1], prior) and torch.equal(g[:slot - 1], f[:slot - 1])
    with pytest.raises(ValueError):
        thf.sweep_seed(bounds, 0, f)  # slot 0 has no slot before it


@pytest.fixture(scope="module")
def scene():
    return make_scene(H, W, seed=3)


@pytest.mark.parametrize("parity", ["reference", "opencv"])
def test_threshold_sweep_matches_pallas(scene, parity):
    cfg = CannyConfig(height=H, width=W, parity=parity, hysteresis_scan_after=2)
    lows, highs = np.int32(LOWS), np.int32(HIGHS)
    want_maps, want_counts = threshold_sweep_pallas(
        jnp.asarray(scene), jnp.asarray(lows), jnp.asarray(highs), cfg, interpret=True)
    maps, counts = tcanny.threshold_sweep(torch.from_numpy(scene), torch.from_numpy(lows),
                                          torch.from_numpy(highs), cfg)
    assert maps.dtype == torch.uint8 and counts.dtype == torch.int32
    np.testing.assert_array_equal(maps.numpy(), np.asarray(want_maps))
    np.testing.assert_array_equal(counts.numpy(), np.asarray(want_counts))
    # The negative lows gate by NMS keep, as xla_ops does: -1 clamps to the
    # same bound as 0.
    zero, _ = tcanny.threshold_sweep(torch.from_numpy(scene), torch.tensor([0], dtype=torch.int32),
                                     torch.tensor([40], dtype=torch.int32), cfg)
    assert torch.equal(maps[1], zero[0])


def test_plain_sweep_matches_xla_ops(scene):
    """The converged maps: the cold plain sweep (torch_ops), the seeded
    dispatch and xla_ops.threshold_sweep, negative lows included."""
    cfg = CannyConfig(height=H, width=W, hysteresis_scan_after=2)
    lows, highs = np.int32(LOWS[:4]), np.int32(HIGHS[:4])
    want_maps, want_counts = xla_ops.threshold_sweep(
        jnp.asarray(scene), jnp.asarray(lows), jnp.asarray(highs), cfg)
    for fn in (torch_ops.threshold_sweep, tcanny.threshold_sweep):
        maps, counts = fn(torch.from_numpy(scene), torch.from_numpy(lows),
                          torch.from_numpy(highs), cfg)
        np.testing.assert_array_equal(maps.numpy(), np.asarray(want_maps))
        np.testing.assert_array_equal(counts.numpy(), np.asarray(want_counts))


def test_sweep_bounds_floor_divide_negative_lows():
    """'reference' bounds are threshold_magnitude_bound - 1 with floor
    division (C's '/' would round -13 / 4 up), lows unclamped."""
    lows = np.int32([-3, -1, 0, 10, 255])
    highs = np.int32([40, 40, 300, 254, 255])
    for norm, coeff in (("l2", 4), ("l1", 2)):
        cfg = CannyConfig(height=8, width=8, norm=norm, grad_coeff=coeff)
        got = tcanny.sweep_bounds(torch.from_numpy(lows), torch.from_numpy(highs), cfg)
        want = [int(xla_ops.threshold_magnitude_bound(jnp.int32(t), coeff, norm)) - 1
                for pair in zip(lows, highs) for t in pair]
        assert got.dtype == torch.int32 and got.tolist() == want
    cfg = CannyConfig(height=8, width=8, parity="opencv")
    got = tcanny.sweep_bounds(torch.from_numpy(lows), torch.tensor([40, 40, 3000, 254, 255],
                                                                   dtype=torch.int32), cfg)
    assert got.tolist() == [0, 1600, 0, 1600, 0, 2048 ** 2, 100, 254 ** 2, 255 ** 2, 255 ** 2]


def test_engine_threshold_sweep(scene):
    cfg = config_from_jax(CannyConfig(height=H, width=W))
    maps, counts = CannyEngine(cfg, device="cpu").threshold_sweep(scene, LOWS, HIGHS)
    assert tuple(maps.shape) == (len(LOWS), H, W) and maps.device.type == "cpu"
    want, want_counts = tcanny.threshold_sweep(
        torch.from_numpy(scene), torch.tensor(LOWS, dtype=torch.int32),
        torch.tensor(HIGHS, dtype=torch.int32), cfg)
    assert torch.equal(maps, want) and torch.equal(counts, want_counts)
    assert torch.equal(maps[0], maps[4])  # the duplicate pair
    empty, none = CannyEngine(cfg, device="cpu").threshold_sweep(scene, [], [])
    assert tuple(empty.shape) == (0, H, W) and tuple(none.shape) == (0,)


def test_engine_threshold_sweep_validation():
    eng = CannyEngine(config_from_jax(CannyConfig(height=16, width=16)), device="cpu")
    f = np.zeros((16, 16, 3), np.uint8)
    with pytest.raises(ValueError):
        eng.threshold_sweep(f, [1, 2], [3])
    with pytest.raises(ValueError):
        eng.threshold_sweep(f, [[1]], [[2]])
    with pytest.raises(ValueError):
        eng.threshold_sweep(np.zeros((2, 16, 16, 3), np.uint8), [1], [2])


def test_cli_sweep_json(capsys):
    rc = cli_main(["sweep", "--device", "cpu", "--source", "synthetic:32x48",
                   "--lows", "5,40", "--highs", "20,120"])
    assert rc == 0
    rep = json.loads(capsys.readouterr().out)
    # cross product keeps lo<=hi pairs: (5,20),(5,120),(40,120)
    assert [(r["low"], r["high"]) for r in rep["sweep"]] == [(5, 20), (5, 120), (40, 120)]
    assert rep["frame"] == "32x48" and rep["device"] == "cpu"
    from cudacam_tpu.io import open_source

    with open_source("synthetic:32x48") as src:
        frame = src.read()
    _, counts = torch_ops.threshold_sweep(torch.from_numpy(frame), torch.tensor([5, 5, 40]),
                                          torch.tensor([20, 120, 120]),
                                          CannyConfig(height=32, width=48))
    assert [r["edge_px"] for r in rep["sweep"]] == counts.tolist()
    assert all(r["edge_frac"] == round(r["edge_px"] / (32 * 48), 5) for r in rep["sweep"])


def test_cli_sweep_zip_and_save(tmp_path, capsys):
    rc = cli_main(["sweep", "--device", "cpu", "--source", "synthetic:32x48", "--zip",
                   "--lows", "5,-3,50", "--highs", "20,30,40", "--save-dir", str(tmp_path)])
    assert rc == 0
    out = capsys.readouterr().out
    rep = json.loads(out[: out.rindex("}") + 1])
    assert [(r["low"], r["high"]) for r in rep["sweep"]] == [(5, 20), (-3, 30)]
    assert sorted(p.name for p in tmp_path.iterdir()) == ["edges_lo-3_hi30.png",
                                                          "edges_lo5_hi20.png"]
    assert cli_main(["sweep", "--device", "cpu", "--zip", "--lows", "1,2", "--highs", "3"]) == 2


def test_cli_info_and_device(capsys):
    assert cli_main(["info", "--device", "cpu"]) == 0
    info = json.loads(capsys.readouterr().out)
    assert info["selected_device"] == "cpu"
    assert {"torch", "cuda_available", "nvcc", "triton", "kernel_sizes", "stages",
            "default_thresholds", "version"} <= info.keys()
    if torch.cuda.is_available():
        return
    # --device cuda never runs on the CPU in its place.
    for argv in (["info"], ["sweep", "--source", "synthetic:32x48"]):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli_main(argv)
