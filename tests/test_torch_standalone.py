"""The port stands alone: it imports nothing of JAX or of the JAX package,
and its own copies of what it took from there (config, stages, the oracle's
constants, the frame sources, ``convert``) equal the originals."""
from __future__ import annotations

import ast
import dataclasses
import pkgutil
import struct
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import cudacam_tpu
import cudacam_tpu_torch
from cudacam_tpu import config as jax_config
from cudacam_tpu import stages as jax_stages
from cudacam_tpu.cli import main as jax_cli
from cudacam_tpu.io import sources as jax_sources
from cudacam_tpu.ops import numpy_oracle
from cudacam_tpu_torch import config, stages
from cudacam_tpu_torch.cli import main as port_cli
from cudacam_tpu_torch.io import sources
from cudacam_tpu_torch.ops import torch_ops
from cudacam_tpu_torch.state import config_from_jax

_REPO = Path(__file__).resolve().parents[1]

_BLOCKED = """
import importlib.abc, sys

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "cudacam_tpu"):
            raise ImportError(f"blocked: {name}")
        return None

sys.meta_path.insert(0, Block())
"""


def test_every_module_imports_with_jax_and_the_jax_package_blocked():
    names = sorted(m.name for m in pkgutil.walk_packages(cudacam_tpu_torch.__path__,
                                                         "cudacam_tpu_torch.")
                   if not m.name.endswith("__main__"))
    assert "cudacam_tpu_torch.parallel.sharded" in names and len(names) > 20
    for new in ("app", "io.ring", "io.metrics", "io.multi", "io.compose", "io.keys", "io.server",
                "utils.logging", "utils.timer", "utils.devtime", "utils.debug",
                "ops.cuda.hysteresis", "probes.hyster_kernel", "probes.i16_swar",
                "benchmark", "parity", "native"):
        assert f"cudacam_tpu_torch.{new}" in names
    code = _BLOCKED + (
        "import importlib, numpy as np\n"
        f"for name in {names!r}:\n"
        "    importlib.import_module(name)\n"
        "from cudacam_tpu_torch import CannyConfig, CannyStage\n"
        "from cudacam_tpu_torch.engine import CannyEngine\n"
        "from cudacam_tpu_torch.io import make_scene\n"
        "eng = CannyEngine(CannyConfig(height=37, width=53), device='cpu')\n"
        "out = eng.process(make_scene(37, 53, seed=2))\n"
        "assert out.shape == (37, 53) and int((out == 255).sum()) > 0\n"
        "assert eng.process(np.zeros((37, 53, 3), np.uint8), CannyStage.NMS).sum() == 0\n"
        "from cudacam_tpu_torch.app import CannyApp\n"
        "from cudacam_tpu_torch.io import SyntheticSource\n"
        "from cudacam_tpu_torch.cli import main\n"
        "with CannyApp(SyntheticSource(height=24, width=32, n_frames=4), device='cpu') as app:\n"
        "    assert app.run(3) == 3 and app.ring.latest_np().shape == (24, 32)\n"
        "assert main(['run', '--device', 'cpu', '--source', 'synthetic:24x32', '--frames', '2',\n"
        "             '--continuation', 'split']) == 0\n"
        "from cudacam_tpu_torch import benchmark, parity\n"
        "benchmark.main(device='cpu', height=24, width=32)\n"
        "frame = make_scene(32, 48, seed=3)\n"
        "assert set(parity.compare_frame(frame, device='cpu')) >= {'exact_iou'}\n"
        "assert parity.cv2_input(frame).shape == (32, 48)\n"
        "import importlib.util\n"
        "for tool in ('port_kernel_probe', 'port_i16_probe'):\n"
        "    spec = importlib.util.spec_from_file_location(tool, f'tools/{tool}.py')\n"
        "    mod = importlib.util.module_from_spec(spec)\n"
        "    spec.loader.exec_module(mod)\n"
        "    assert mod.main(['--device', 'cpu']) == 0\n"
        "import tempfile\n"
        "from cudacam_tpu_torch.native import FramePump, write_rawv\n"
        "from cudacam_tpu_torch.io.sources import RawvSource\n"
        "from cudacam_tpu_torch.ops.cuda import hysteresis_fused_batched\n"
        "clip = np.stack([make_scene(24, 32, seed=s) for s in range(3)])\n"
        "path = write_rawv(tempfile.mkdtemp() + '/clip.rawv', clip)\n"
        "with FramePump(path) as pump:\n"
        "    assert (pump.read() == clip[0]).all()\n"
        "with CannyApp(RawvSource(path), device='cpu') as app:\n"
        "    assert app.run(None) == 3\n"
        "    assert eng.process_all(np.stack([make_scene(37, 53, seed=s) for s in (1, 2)]))[\n"
        "        'hyster'].shape == (2, 37, 53)\n"
        "assert not [m for m in sys.modules if m.split('.')[0] in ('jax', 'cudacam_tpu')]\n"
        "print('standalone ok')\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=_REPO, capture_output=True, text=True,
                         timeout=240)
    assert res.returncode == 0 and "standalone ok" in res.stdout, res.stdout + res.stderr


_EXAMPLES = sorted((_REPO / "examples").glob("torch_*.py"))


@pytest.mark.parametrize("path", _EXAMPLES, ids=[p.name for p in _EXAMPLES])
def test_examples_import_only_the_port(path):
    """The port's examples import nothing of JAX or the JAX package: their
    own imports are the port's modules (each imported above with both
    blocked), the standard library and numpy."""
    tree = ast.parse(path.read_text())
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            roots.add(node.module.split(".")[0])
    assert "cudacam_tpu_torch" in roots
    assert not roots & {"jax", "jaxlib", "cudacam_tpu"}, roots
    assert roots <= {"cudacam_tpu_torch", "numpy", "torch", "argparse", "os", "sys", "typing",
                     "threading", "time"}, roots


def test_there_are_four_examples():
    assert [p.name for p in _EXAMPLES] == ["torch_basic.py", "torch_custom_source.py",
                                           "torch_live_controls.py",
                                           "torch_sharded_megaframe.py"]


#: The JAX package's fields that select one of its executors: the port's
#: route follows the tensors' device, so its config has no such field.
_JAX_ONLY = ("backend", "interpret")
#: Fields both have, with values of their own ('continuation': the JAX
#: package's auto | pallas | xla | split, the port's auto | kernel | split).
_OWN_VALUES = ("continuation",)


def _shared(cfg) -> dict:
    return {k: v for k, v in dataclasses.asdict(cfg).items() if k not in _JAX_ONLY}


def test_canny_config_is_a_copy():
    jf = {f.name: f.default for f in dataclasses.fields(jax_config.CannyConfig)}
    pf = {f.name: f.default for f in dataclasses.fields(config.CannyConfig)}
    assert set(_JAX_ONLY) <= set(jf)
    assert {k: v for k, v in jf.items() if k not in _JAX_ONLY} == pf
    assert config.GAUSSIAN_TAPS == jax_config.GAUSSIAN_TAPS
    for ks in (3, 5, 7):
        assert config.gaussian_kernel_sum(ks) == jax_config.gaussian_kernel_sum(ks)
    for kw in (dict(height=1080, width=1920), dict(height=2160, width=3840, parity="opencv"),
               dict(height=4320, width=7680, kernel_size=7), dict(height=37, width=53, channels=1),
               dict(height=64, width=96, low_threshold=0, high_threshold=255,
                    hysteresis_inner_steps=3, hysteresis_scan_after=2)):
        j, p = jax_config.CannyConfig(**kw), config.CannyConfig(**kw)
        assert _shared(j) == dataclasses.asdict(p)
        assert (j.halo, j.threshold_cap) == (p.halo, p.threshold_cap)
        assert _shared(j.with_thresholds(-3, 900)) == dataclasses.asdict(
            p.with_thresholds(-3, 900))
        assert config_from_jax(j) == p
        for jcont, cont in (("split", "split"), ("pallas", "auto"), ("xla", "auto"),
                            ("auto", "auto")):
            assert config_from_jax(jax_config.CannyConfig(
                **kw, backend="xla", interpret=True, continuation=jcont)) == dataclasses.replace(
                    p, continuation=cont)


@pytest.mark.parametrize("name,value", [("backend", "xla"), ("interpret", True),
                                        ("continuation", "pallas")])
def test_jax_only_fields_are_not_in_the_port(name, value):
    """The executor fields have no counterpart; ``continuation`` returned
    with the port's own values, so the JAX package's 'pallas' is refused."""
    jax_config.CannyConfig(height=64, width=96, **{name: value})
    with pytest.raises(ValueError if name in _OWN_VALUES else TypeError):
        config.CannyConfig(height=64, width=96, **{name: value})


@pytest.mark.parametrize("bad", [
    dict(kernel_size=4), dict(norm="l3"), dict(channels=2),
    dict(parity="x"), dict(grad_coeff=3), dict(height=0),
    dict(hysteresis_inner_steps=0), dict(hysteresis_scan_after=0), dict(low_threshold=300),
    dict(low_threshold=50, high_threshold=40), dict(parity="opencv", high_threshold=3000),
])
def test_canny_config_validation_is_a_copy(bad):
    kw = dict(dict(height=64, width=96), **bad)
    with pytest.raises(ValueError) as jerr:
        jax_config.CannyConfig(**kw)
    with pytest.raises(ValueError) as perr:
        config.CannyConfig(**kw)
    assert str(perr.value) == str(jerr.value)


def test_stages_are_a_copy():
    assert [(s.name, int(s)) for s in stages.CannyStage] == [
        (s.name, int(s)) for s in jax_stages.CannyStage]
    assert {int(k): v for k, v in stages.CANNY_STAGE_NAMES.items()} == {
        int(k): v for k, v in jax_stages.CANNY_STAGE_NAMES.items()}
    assert (stages.FINAL_EDGE, stages.CANDIDATE_EDGE, stages.NO_EDGE) == (
        jax_stages.FINAL_EDGE, jax_stages.CANDIDATE_EDGE, jax_stages.NO_EDGE)
    assert cudacam_tpu_torch.CannyStage is stages.CannyStage
    assert cudacam_tpu.CannyStage is jax_stages.CannyStage


def test_oracle_constants_are_a_copy():
    assert (torch_ops.B_WT, torch_ops.G_WT, torch_ops.R_WT) == (
        numpy_oracle.B_WT, numpy_oracle.G_WT, numpy_oracle.R_WT)
    assert (torch_ops.TG22, torch_ops.TG67) == (numpy_oracle.TG22, numpy_oracle.TG67)
    np.testing.assert_array_equal(torch_ops.SOBEL_X, numpy_oracle.SOBEL_X)
    np.testing.assert_array_equal(torch_ops.SOBEL_Y, numpy_oracle.SOBEL_Y)


@pytest.mark.parametrize("seed", range(8))
def test_make_scene_is_a_copy(seed):
    for h, w, t in ((120, 160, 0.0), (37, 53, 0.5), (240, 320, 1.25)):
        got = sources.make_scene(h, w, seed=seed, t=t)
        assert got.dtype == np.uint8 and got.tobytes() == jax_sources.make_scene(
            h, w, seed=seed, t=t).tobytes()


@pytest.mark.parametrize("h,w", [(64, 128), (96, 384), (37, 53), (1080, 1920)])
def test_spiral_frames_are_a_copy(h, w):
    assert sources.make_spiral_frame(h, w).tobytes() == jax_sources.make_spiral_frame(h, w).tobytes()
    assert sources.make_spiral_thresh(h, w).tobytes() == jax_sources.make_spiral_thresh(
        h, w).tobytes()
    with pytest.raises(ValueError):
        sources.make_spiral_frame(20, 20)


def test_synthetic_sources_are_a_copy():
    for spec in ("synthetic:48x64", "synthetic:48x64x1", "spiral:40x72"):
        with sources.open_source(spec, n_frames=3) as src, \
                jax_sources.open_source(spec, n_frames=3) as jsrc:
            got, want = list(src), list(jsrc)
        assert len(got) == len(want) == 3
        assert all(g.tobytes() == e.tobytes() for g, e in zip(got, want))


def test_convert_writes_the_jax_package_bytes(tmp_path):
    rng = np.random.default_rng(3)
    clip = rng.integers(0, 256, size=(4, 24, 40, 3), dtype=np.uint8)
    src = tmp_path / "clip.npy"
    np.save(src, clip)
    for spec in (str(src), "synthetic:24x40", "synthetic:24x40x1"):
        assert port_cli(["convert", spec, str(tmp_path / "port.npy"), "--frames", "3"]) == 0
        assert jax_cli(["convert", spec, str(tmp_path / "jax.npy"), "--frames", "3"]) == 0
        assert (tmp_path / "port.npy").read_bytes() == (tmp_path / "jax.npy").read_bytes()
    # .rawv: the header of cudacam_tpu/native/framepump.cpp, then the frames
    assert port_cli(["convert", str(src), str(tmp_path / "clip.rawv"), "--frames", "0"]) == 0
    raw = (tmp_path / "clip.rawv").read_bytes()
    assert raw == struct.pack("<IIIIIQ", 0x56574152, 1, 24, 40, 3, 4) + clip.tobytes()
    with sources.open_source(str(tmp_path / "clip.rawv")) as rsrc:
        back = np.stack(list(rsrc))
    np.testing.assert_array_equal(back, clip)
    assert port_cli(["convert", str(src), str(tmp_path / "clip.png")]) == 2


def _extern_c(src: str) -> dict:
    """name -> normalized signature of every function in the C ABI block."""
    import re

    body = src[src.index('extern "C" {'):]
    return {m.group(2): " ".join(m.group(0).split())
            for m in re.finditer(r"^([\w\s\*]+?)\b(fp_\w+)\(([^)]*)\)", body, re.M)}


def test_frame_pump_source_is_a_copy():
    """The port's ``native/framepump.cpp`` keeps the JAX package's stream
    format (header, magic) and every entry point of its C ABI with the same
    signature; it adds only the slot accessors."""
    jax_src = (_REPO / "cudacam_tpu" / "native" / "framepump.cpp").read_text()
    port_src = (_REPO / "cudacam_tpu_torch" / "native" / "framepump.cpp").read_text()
    for part in ("struct Header {", "constexpr uint32_t kMagic"):
        start = jax_src.index(part)
        block = jax_src[start:jax_src.index("}", start) + 1] if "{" in part else \
            jax_src[start:jax_src.index("\n", start)]
        assert block in port_src, part
    want, got = _extern_c(jax_src), _extern_c(port_src)
    assert len(want) == 11 and {k: got[k] for k in want} == want
    assert set(got) - set(want) == {"fp_slot_count", "fp_slot", "fp_frame_bytes"}
