"""The port's probe kernels (K13, K14) against the JAX probes themselves.

``tools/hyster_kernel_probe.py`` and ``tools/i16_swar_probe.py`` are run as
they are, with ``pallas_call`` wrapped so that every kernel runs in
interpret mode and its inputs and outputs are recorded; the plain versions
of ``cudacam_tpu_torch/probes`` are then held to the recorded outputs on the
recorded inputs, tolerance 0 (bit masks and integers). The JAX kernels are
also re-run on edge inputs of the probe's shape. Where a contract reaches
past the JAX probe (another round budget, another plane size: its bodies
read the module's H and W), an independent NumPy version of the same
contract is the reference. The kernels themselves run in
``tests/test_torch_cuda.py`` on a card.
"""
from __future__ import annotations

import importlib.util
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from cudacam_tpu_torch.probes import hyster_kernel as hk
from cudacam_tpu_torch.probes import i16_swar

_REPO = Path(__file__).resolve().parents[1]


def _load_tool(name: str):
    spec = importlib.util.spec_from_file_location(f"_jax_{name}", _REPO / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run_recorded(monkeypatch, fns):
    """Call ``fns`` with every ``pallas_call`` in interpret mode; returns
    (what they returned, [(kernel, call kwargs, input arrays, output
    arrays)] in call order)."""
    calls = []
    real = pl.pallas_call

    def recording(kernel, **kw):
        run = real(kernel, interpret=True, **kw)

        def call(*args):
            out = run(*args)
            outs = out if isinstance(out, (list, tuple)) else [out]
            calls.append((kernel, kw, [np.asarray(a) for a in args],
                          [np.asarray(o) for o in outs]))
            return out
        return call

    monkeypatch.setattr(pl, "pallas_call", recording)
    returned = [fn() for fn in fns]
    monkeypatch.setattr(pl, "pallas_call", real)
    return returned, calls


@pytest.fixture(scope="module")
def hyster_calls():
    mp = pytest.MonkeyPatch()
    try:
        tool = _load_tool("hyster_kernel_probe")
        oks, calls = _run_recorded(mp, [tool.probe_pack, tool.probe_pack_loop,
                                        tool.probe_loop_scratch, tool.probe_unpack])
    finally:
        mp.undo()
    assert oks == [True] * 4 and len(calls) == 4
    return calls


@pytest.fixture(scope="module")
def swar_calls():
    mp = pytest.MonkeyPatch()
    try:
        tool = _load_tool("i16_swar_probe")
        _, calls = _run_recorded(mp, [tool.main])
    finally:
        mp.undo()
    assert len(calls) == 4  # every body ran (COMPILED) in interpret mode
    return calls


def _i32(words: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(words).view(np.int32))


# -- K13 -------------------------------------------------------------------


@pytest.mark.parametrize("index,port", [(0, hk.probe_pack_plain), (1, hk.probe_pack_ballot_plain),
                                        (0, hk.probe_pack), (1, hk.probe_pack_ballot)])
def test_pack_probes_equal_the_jax_probe(hyster_calls, index, port):
    _, _, (mask,), (words,) = hyster_calls[index]
    np.testing.assert_array_equal(mask, hk.pack_input(index))  # the port's copy of the input
    assert torch.equal(port(torch.from_numpy(mask.copy())), _i32(words))


def test_loop_probe_equals_the_jax_probe(hyster_calls):
    _, _, (plane,), (out, flags) = hyster_calls[2]
    np.testing.assert_array_equal(plane.view(np.int32), hk.loop_input())
    got, got_flags = hk.probe_loop(_i32(plane))
    assert torch.equal(got, _i32(out)) and got_flags.tolist() == flags.tolist() == [[326, 0]]
    assert int(hk.bitpack.unpack_mask(got, 32 * 40).sum()) == 40 * 256 * 32  # all 327 680 bits


@pytest.mark.parametrize("per_word", [True, False])
def test_unpack_probe_equals_the_jax_probe(hyster_calls, per_word):
    _, _, (words,), (out,) = hyster_calls[3]
    np.testing.assert_array_equal(words.view(np.int32), hk.unpack_input())
    assert torch.equal(hk.probe_unpack(_i32(words), per_word), torch.from_numpy(out))


def _loop_numpy(plane: np.ndarray, max_rounds: int):
    """The loop's contract in NumPy uint32, independent of the port."""
    f = plane.view(np.uint32).copy()
    it = 0
    while True:
        nf = f | np.roll(f, 1, 0) | np.roll(f, f.shape[1] - 1, 1) | (f << np.uint32(1))
        changed = bool((nf != f).any())
        f, it = nf, it + 1
        if not changed or it >= max_rounds:
            return f.view(np.int32), [[it, int(changed)]]


def _edge_planes():
    top31 = np.zeros((40, 256), np.int32)
    top31[0, 0] = np.int32(-2**31)  # bit 31 only: a shift drops it
    corner = np.zeros((40, 256), np.int32)
    corner[39, 255] = 1  # both rolls wrap at once
    rng = np.random.default_rng(3)
    sparse = (rng.integers(0, 2**32, (40, 256), dtype=np.uint32)
              & rng.integers(0, 2**32, (40, 256), dtype=np.uint32)
              & rng.integers(0, 2**32, (40, 256), dtype=np.uint32)).view(np.int32)
    return {"bit 31": top31, "corner": corner, "sparse": sparse}


@pytest.mark.parametrize("name", ["bit 31", "corner", "sparse"])
def test_loop_probe_edges_equal_the_jax_kernel(hyster_calls, name):
    """The JAX kernel itself (interpret mode) on edge planes of its shape."""
    kernel, kw, _, _ = hyster_calls[2]
    plane = _edge_planes()[name]
    out, flags = pl.pallas_call(kernel, interpret=True, **kw)(jnp.asarray(plane.view(np.uint32)))
    got, got_flags = hk.probe_loop(torch.from_numpy(plane))
    assert torch.equal(got, _i32(np.asarray(out)))
    assert got_flags.tolist() == np.asarray(flags).tolist()


def test_loop_probe_drops_bit_31_and_wraps_both_axes():
    plane = _edge_planes()["bit 31"]
    got, flags = hk.probe_loop(torch.from_numpy(plane), 1)
    want = np.zeros((40, 256), np.int32)
    want[0, 0] = want[1, 0] = want[0, 255] = np.int32(-2**31)  # no bit 0 anywhere
    assert torch.equal(got, torch.from_numpy(want)) and flags.tolist() == [[1, 1]]
    corner = np.zeros((3, 4), np.int32)
    corner[2, 0] = 1
    got, _ = hk.probe_loop(torch.from_numpy(corner), 1)
    want = np.zeros((3, 4), np.int32)
    want[2, 0], want[0, 0], want[2, 3] = 3, 1, 1  # the shift, the row wrap, the column wrap
    assert torch.equal(got, torch.from_numpy(want))


@pytest.mark.parametrize("cap", [1, 2, 5, 37])
def test_loop_probe_cut_off_by_a_small_cap(cap):
    plane = hk.loop_input()
    got, flags = hk.probe_loop(torch.from_numpy(plane), cap)
    want, want_flags = _loop_numpy(plane, cap)
    assert flags.tolist() == want_flags == [[cap, 1]]
    assert torch.equal(got, torch.from_numpy(want))


def test_loop_probe_sync_only_and_odd_planes():
    plane = torch.from_numpy(_edge_planes()["sparse"][:7, :9].copy())
    out, flags = hk.probe_loop(plane, 1000, sync_only=True)
    assert torch.equal(out, plane) and flags.tolist() == [[1000, 0]]
    for shape in ((1, 1), (7, 9), (33, 5)):
        x = _edge_planes()["sparse"][:shape[0], :shape[1]].copy()
        got, got_flags = hk.probe_loop(torch.from_numpy(x))
        want, want_flags = _loop_numpy(x, hk.LOOP_ROUNDS)
        assert torch.equal(got, torch.from_numpy(want)) and got_flags.tolist() == want_flags


@pytest.mark.parametrize("h,w", [(1, 1), (37, 53), (540, 96)])
def test_pack_and_unpack_probes_at_other_sizes(h, w):
    mask = hk.pack_input(h + w, h, w) * np.uint8(7)  # any nonzero byte is a set bit
    words = hk.probe_pack(torch.from_numpy(mask))
    assert torch.equal(words, hk.probe_pack_ballot(torch.from_numpy(mask)))
    back = hk.probe_unpack(words)
    assert back.shape == (32 * -(-h // 32), w) and not back[h:].any()
    np.testing.assert_array_equal(back[:h].numpy(), np.where(mask != 0, 255, 0))


def test_probe_wrappers_refuse_other_inputs():
    with pytest.raises(ValueError):
        hk.probe_pack(torch.zeros((4, 4), dtype=torch.int32))
    with pytest.raises(ValueError):
        hk.probe_unpack(torch.zeros((4, 4), dtype=torch.uint8))
    with pytest.raises(ValueError):
        hk.probe_loop(torch.zeros((0, 4), dtype=torch.int32))
    with pytest.raises(ValueError):
        i16_swar.swar_stencil(torch.zeros((4, 4), dtype=torch.uint8), 1)
    with pytest.raises(ValueError):
        i16_swar.swar_stencil(torch.zeros((4, 4), dtype=torch.int16), 5)
    with pytest.raises(ValueError):
        hk.grid_sync_us("cpu")


# -- K14 -------------------------------------------------------------------


@pytest.mark.parametrize("body", [1, 2, 3, 4])
@pytest.mark.parametrize("swar", [True, False])
def test_swar_bodies_equal_the_jax_probe(swar_calls, body, swar):
    _, _, (x,), (out,) = swar_calls[body - 1]
    xi16, xu8 = i16_swar.probe_inputs()
    np.testing.assert_array_equal(x, xu8 if body == 4 else xi16)
    got = i16_swar.swar_stencil(torch.from_numpy(x), body, swar)
    assert torch.equal(got, torch.from_numpy(out))


def test_swar_outputs_fit_int16(swar_calls):
    """The ranges of the four bodies: every lane fits int16, so two 16-bit
    lanes per register are exact on these inputs."""
    ranges = [(int(o.min()), int(o.max())) for _, _, _, (o,) in swar_calls]
    assert ranges == [(0, 1778), (8, 755), (12, 1515), (341, 2754)]
    for body, (_, _, (x,), (out,)) in enumerate(swar_calls, 1):
        assert torch.equal(i16_swar.wide_reference(torch.from_numpy(x), body), torch.from_numpy(out))


def _body_numpy(x: np.ndarray, body: int) -> np.ndarray:
    """The bodies in NumPy int16 with the probe's roll semantics at any
    size (the JAX bodies read the module's H and W)."""
    h, w = x.shape
    x = x.astype(np.int16)
    with np.errstate(over="ignore"):
        if body == 1:
            y = x * np.int16(3) + (x + x) * np.int16(2)
        elif body == 2:
            y = x + np.roll(x, 1, 0) + np.roll(x, h - 1, 0)
        elif body == 3:
            y = x * np.int16(2) + np.roll(x, 1, 1) * np.int16(3) + np.roll(x, w - 1, 1)
        else:
            v = x + np.roll(x, 1, 0) + np.roll(x, h - 1, 0)
            y = v * np.int16(2) + np.roll(v, 1, 1) + np.roll(v, w - 1, 1)
    return y.astype(np.int32)


@pytest.mark.parametrize("shape", [(1, 1), (1, 9), (7, 9), (5, 2), (3, 513)])
@pytest.mark.parametrize("body", [1, 2, 3, 4])
def test_swar_bodies_on_tiny_and_odd_planes(shape, body):
    rng = np.random.default_rng(shape[0] * 1000 + shape[1])
    x = (rng.integers(0, 255, shape, np.uint8) if body == 4
         else rng.integers(-2**15, 2**15, shape, np.int16))  # wrapping lanes included
    for swar in (True, False):
        got = i16_swar.swar_stencil(torch.from_numpy(x), body, swar)
        np.testing.assert_array_equal(got.numpy(), _body_numpy(x, body))


# -- the port's tools, with the JAX packages blocked --------------------------

_BLOCKED = """
import importlib.abc, runpy, sys

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "cudacam_tpu"):
            raise ImportError(f"blocked: {name}")
        return None

sys.meta_path.insert(0, Block())
"""


@pytest.mark.parametrize("tool,lines", [("port_kernel_probe", 5), ("port_i16_probe", 4)])
def test_port_tools_print_ok_without_jax(tool, lines):
    code = _BLOCKED + (
        f"sys.argv = ['{tool}.py', '--device', 'cpu']\n"
        f"try:\n    runpy.run_path('tools/{tool}.py', run_name='__main__')\n"
        "except SystemExit as e:\n    assert e.code == 0, e.code\n"
        "assert not [m for m in sys.modules if m.split('.')[0] in ('jax', 'cudacam_tpu')]\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=_REPO, capture_output=True, text=True,
                         timeout=240)
    out = res.stdout.strip().splitlines()
    assert res.returncode == 0, res.stdout + res.stderr
    assert len(out) == lines + 1 and all(": OK" in line for line in out[:-1]), res.stdout
    assert out[-1].startswith("ALL OK")
