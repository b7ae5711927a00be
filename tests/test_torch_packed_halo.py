"""The port's packed halo exchange and collective round loop
(``cudacam_tpu_torch/ops/packed_strips.py``: geometry, strips, the exchange;
``cudacam_tpu_torch/parallel/packed_halo.py``: the loop) against the JAX package's
(``cudacam_tpu/parallel/packed_halo.py``) under ``shard_map`` on the
virtual CPU mesh.

The JAX planes carry a zero guard word row past the extended tile; the
port's do not, so the JAX side gets the port's planes with that row added
and is compared on the extended tile's (ceil(ext_h/32), ext_w) words.
Tolerance 0: every output is packed bits or a flag.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from cudacam_tpu import CannyConfig as JaxConfig
from cudacam_tpu.io.sources import make_scene, make_spiral_frame
from cudacam_tpu.parallel import packed_halo as jph
from cudacam_tpu.parallel.mesh import AXES
from cudacam_tpu.parallel.mesh import make_mesh as jax_mesh
from cudacam_tpu.parallel.sharded import xla_packed_saturate
from cudacam_tpu_torch.ops import packed_strips as ps
from cudacam_tpu_torch.ops.cuda.canny import hyster_kwargs, pipeline_kwargs
from cudacam_tpu_torch.ops.cuda.hysteresis_fused import saturate_packed
from cudacam_tpu_torch.ops.cuda.megakernel import mega_export
from cudacam_tpu_torch.parallel import build_sharded_pipeline, make_mesh
from cudacam_tpu_torch.parallel import packed_halo as ph
from cudacam_tpu_torch.state import config_from_jax

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")


def _to_torch(words: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(words, np.uint32).view(np.int32))


def _to_np(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


def _random_words(rng, shape, ext_h=None):
    """Random uint32 words, bit 31 set in about half of them; with ``ext_h``
    the bits past the extended tile's last row are zero (the layout's
    invariant)."""
    w = rng.integers(0, 2**32, size=shape, dtype=np.uint64).astype(np.uint32)
    w &= rng.integers(0, 2**32, size=shape, dtype=np.uint64).astype(np.uint32)
    w[..., ::2, :] |= np.uint32(1 << 31)
    if ext_h is not None and ext_h % 32:
        w[..., -1, :] &= np.uint32((1 << (ext_h % 32)) - 1)
    return w


@pytest.mark.parametrize("h_loc,w_loc,ny,nx", [
    (540, 960, 2, 2), (1080, 1920, 1, 1), (8, 12, 2, 2), (8, 96, 8, 1), (16, 24, 4, 2),
    (40, 200, 2, 1), (33, 65, 3, 3), (1, 1, 2, 2), (1080, 960, 1, 4), (2160, 3840, 2, 1),
])
def test_make_geo_matches_jax(h_loc, w_loc, ny, nx):
    got = ps.make_geo(h_loc, w_loc, ny=ny, nx=nx)
    want = jph.make_geo(h_loc, w_loc, granule=False, ny=ny, nx=nx)
    for name in ("h_loc", "w_loc", "e_top", "e_bot", "e_left", "e_right", "ext_h", "ext_w", "hw"):
        assert getattr(got, name) == getattr(want, name), name
    assert want.plane_rows == got.hw + 1 and want.plane_lanes == got.ext_w  # the JAX guard row


@pytest.mark.parametrize("b", [0, 1, 5, 31, 32, 33, 63, 64, 70, -3, -31])
def test_extract32_matches_jax(b):
    x = _random_words(np.random.default_rng(b + 40), (4, 8))
    got = ps._extract32(_to_torch(x), b)
    np.testing.assert_array_equal(_to_np(got), np.asarray(jph._extract32(jnp.asarray(x), b))[0])
    for bad in (-32, 128):
        with pytest.raises(ValueError):
            ps._extract32(_to_torch(x), bad)


@pytest.mark.parametrize("b,cap", [(0, 128), (3, 128), (32, 128), (45, 128), (-5, 128),
                                   (100, 110), (96, 128), (-20, 7), (120, 110)])
def test_or_place32_matches_jax(b, cap):
    rng = np.random.default_rng(abs(b) * 7 + cap)
    x = _random_words(rng, (4, 8))
    strip = _random_words(rng, (1, 8))
    got, new = ps._or_place32(_to_torch(x), _to_torch(strip[0]), b, cap)
    want, jnew = jph._or_place32(jnp.asarray(x), jnp.asarray(strip), b, cap)
    np.testing.assert_array_equal(_to_np(got), np.asarray(want))
    assert bool(new) == bool(jnew)
    # a batch of planes places each strip in its own plane
    xs = np.stack([x, np.zeros_like(x)])
    got2, new2 = ps._or_place32(_to_torch(xs), _to_torch(np.stack([strip[0]] * 2)), b, cap)
    np.testing.assert_array_equal(_to_np(got2)[0], np.asarray(want))
    assert new2.shape == (2,) and bool(new2[0]) == bool(jnew)


def _jax_tiles(x: np.ndarray, ny: int, nx: int) -> jnp.ndarray:
    """(ny nx, rows, lanes) tiles -> the global (ny (rows + 1), nx lanes)
    array of their JAX planes (each with a zero guard row)."""
    t, rows, lanes = x.shape
    x = np.concatenate([x, np.zeros((t, 1, lanes), np.uint32)], axis=1)
    g = x.reshape(ny, nx, rows + 1, lanes).transpose(0, 2, 1, 3)
    return jnp.asarray(g.reshape(ny * (rows + 1), nx * lanes))


def _from_jax(g, ny: int, nx: int, rows: int) -> np.ndarray:
    g = np.asarray(g)
    lanes = g.shape[1] // nx
    x = g.reshape(ny, rows + 1, nx, lanes).transpose(0, 2, 1, 3)
    return x.reshape(ny * nx, rows + 1, lanes)[:, :rows]


def _shard_map(fn, ny: int, nx: int, n_out: int, nb: int = 1):
    """``fn`` under ``shard_map`` on an (nb, ny, nx) mesh; the global arrays
    stack the batch over the rows (``_jax_tiles`` with nb ny rows)."""
    mesh = jax_mesh(batch=nb, rows=ny, cols=nx, devices=jax.devices()[: nb * ny * nx])
    spec = P(("b", "y"), "x") if nb > 1 else P("y", "x")
    return jax.jit(jax.shard_map(fn, mesh=mesh, in_specs=(spec,) * n_out,
                                 out_specs=(spec,) * n_out, check_vma=False))


@pytest.mark.parametrize("grid,frame", [((4, 2), (64, 96)), ((2, 4), (72, 200)),
                                        ((8, 1), (64, 96)), ((2, 2), (40, 400))])
def test_exchange_packed_matches_jax(grid, frame):
    ny, nx = grid
    geo = ps.make_geo(frame[0] // ny, frame[1] // nx, ny=ny, nx=nx)
    jgeo = jph.make_geo(geo.h_loc, geo.w_loc, granule=False, ny=ny, nx=nx)
    x = _random_words(np.random.default_rng(ny * nx), (ny * nx, geo.hw, geo.ext_w), geo.ext_h)

    def exchange(xs, _):
        out, new = jph.exchange_packed(xs, jgeo, "y", "x", ny, nx)
        return out, jnp.broadcast_to(new.astype(jnp.uint32), xs.shape)

    g = _jax_tiles(x, ny, nx)
    out, new = _shard_map(exchange, ny, nx, 2)(g, g)
    got, got_new = ps.exchange_packed(_to_torch(x), geo, ny, nx, ps.local_shift(ny, nx))
    np.testing.assert_array_equal(_to_np(got), _from_jax(out, ny, nx, geo.hw))
    np.testing.assert_array_equal(got_new.numpy(), _from_jax(new, ny, nx, geo.hw)[:, 0, 0] == 1)
    assert got_new.any()  # random planes bring new halo bits


@pytest.mark.parametrize("cap,scan_after", [(100, 3), (5, 2)])
@pytest.mark.parametrize("grid", [(2, 2), (4, 1)])
def test_packed_hysteresis_loop_matches_jax(grid, cap, scan_after):
    """The round loop from the export's entry state (the spiral: growth
    across tiles), converged and cut off at ``cap`` rounds, with the XLA
    saturate on the JAX side and the port's saturate and exchange."""
    ny, nx = grid
    h, w = 64, 128
    jcfg = JaxConfig(height=h, width=w, max_hysteresis_iters=cap, hysteresis_scan_after=scan_after,
                     hysteresis_inner_steps=4)
    cfg = config_from_jax(jcfg)
    mesh = make_mesh(1, ny, nx)
    pipe = build_sharded_pipeline(cfg, mesh)
    geo = pipe.geo
    frames = torch.from_numpy(make_spiral_frame(h, w))[None]
    f, p, flags = mega_export(frames, torch.tensor([10, 40], dtype=torch.int32), pipe.tiling,
                              **pipeline_kwargs(cfg))
    f0, p0, still = _to_np(f).copy(), _to_np(p).copy(), flags[:, 0, 1].numpy().copy()

    def saturate(ff, pp):
        return saturate_packed(ff, pp, flags, geo.ext_h, **hyster_kwargs(cfg))[1]

    rounds = ph.packed_hysteresis_loop(f, p, flags[:, 0, 1].clone(), saturate,
                                       lambda x, **kw: mesh.exchange(x, geo, **kw), cap)

    jgeo = jph.make_geo(geo.h_loc, geo.w_loc, granule=False, ny=ny, nx=nx)
    sat = xla_packed_saturate(jcfg, jgeo)

    def loop(ff, pp, grow):
        out = jph.packed_hysteresis_loop(ff, pp, grow[0, 0] == 1, jgeo, sat, AXES, ny, nx, cap)
        return out, pp, grow

    grow = np.broadcast_to(still[:, None, None], (ny * nx, geo.hw, geo.ext_w)).astype(np.uint32)
    out, _, _ = _shard_map(loop, ny, nx, 3)(_jax_tiles(f0, ny, nx), _jax_tiles(p0, ny, nx),
                                            _jax_tiles(grow, ny, nx))
    np.testing.assert_array_equal(_to_np(f), _from_jax(out, ny, nx, geo.hw))
    assert 0 < int(rounds) <= cap


#: Cases of the loop test where a tile is still growing in some round while
#: a tile that is not gains new halo bits: both terms of the pending flag at
#: once.
MIXED = {((4, 1), 5, 2), ((1, 4), 5, 2)}


@pytest.mark.parametrize("cap,scan_after", [(100, 3), (5, 2), (0, 3), (1, 3), (2, 2)])
@pytest.mark.parametrize("grid", [(2, 2), (4, 1), (1, 1), (2, 1), (1, 4), (2, 2, 2)])
def test_sharded_loop_matches_jax(grid, cap, scan_after):
    """The one-card round loop's entry point (on the CPU: its plain version,
    the host loop with the plain saturate and refresh) from the export's
    state against the JAX loop under ``shard_map``, its round count against
    the host loop with the port's saturate and the mesh's refresh. ``grid``
    is (ny, nx), or (nb, ny, nx) with a batch axis (the spiral and a scene);
    budgets 0, 1, 2, 5 and 100."""
    nb, ny, nx = grid if len(grid) == 3 else (1, *grid)
    h, w = 64, 128
    jcfg = JaxConfig(height=h, width=w, max_hysteresis_iters=max(cap, 1),
                     hysteresis_scan_after=scan_after, hysteresis_inner_steps=4)
    cfg = config_from_jax(jcfg)
    mesh = make_mesh(nb, ny, nx)
    pipe = build_sharded_pipeline(cfg, mesh)
    geo = pipe.geo
    frames = torch.from_numpy(np.stack([make_spiral_frame(h, w)] +
                                       [make_scene(h, w, seed=s) for s in range(nb - 1)]))
    f, p, flags = mega_export(frames, torch.tensor([10, 40], dtype=torch.int32), pipe.tiling,
                              **pipeline_kwargs(cfg))
    f0, p0, still = _to_np(f).copy(), _to_np(p).copy(), flags[:, 0, 1].numpy().copy()
    fh, ph_, flh = f.clone(), p.clone(), flags.clone()
    rounds = ph.sharded_loop(f, p, flags, (nb, ny, nx), geo, max_rounds=cap,
                             **hyster_kwargs(cfg))
    mixed = []

    def exchange(x, grow=None, pending=None):
        before = x.clone()
        mesh.exchange(x, geo, grow=grow, pending=pending)
        if grow is not None:
            new = (x != before).flatten(1).any(1)
            mixed.append(any(grow[t] and new[u] and not grow[u] for t in range(len(x))
                             for u in range(len(x)) if u != t))

    host = ph.packed_hysteresis_loop(
        fh, ph_, flh[:, 0, 1].clone(),
        lambda ff, pp: saturate_packed(ff, pp, flh, geo.ext_h, **hyster_kwargs(cfg))[1],
        exchange, cap)
    assert int(rounds) == int(host) <= cap and torch.equal(f, fh) and torch.equal(flags, flh)
    assert any(mixed) == ((grid, cap, scan_after) in MIXED)
    jgeo = jph.make_geo(geo.h_loc, geo.w_loc, granule=False, ny=ny, nx=nx)
    sat = xla_packed_saturate(jcfg, jgeo)

    def loop(ff, pp, grow):
        out = jph.packed_hysteresis_loop(ff, pp, grow[0, 0] == 1, jgeo, sat, AXES, ny, nx, cap)
        return out, pp, grow

    grow = np.broadcast_to(still[:, None, None],
                           (nb * ny * nx, geo.hw, geo.ext_w)).astype(np.uint32)
    out, _, _ = _shard_map(loop, ny, nx, 3, nb)(_jax_tiles(f0, nb * ny, nx),
                                                _jax_tiles(p0, nb * ny, nx),
                                                _jax_tiles(grow, nb * ny, nx))
    np.testing.assert_array_equal(_to_np(f), _from_jax(out, nb * ny, nx, geo.hw))
