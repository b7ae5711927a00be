"""The port's examples (``examples/torch_*.py``) stay runnable: each on
``--device cpu``, printing the lines ``tests/test_examples.py`` looks for in
the JAX package's examples."""
from __future__ import annotations

import os
import runpy
import sys

import pytest

EXAMPLES = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "examples")


def _run(name, capsys, monkeypatch):
    path = os.path.join(EXAMPLES, name)
    monkeypatch.setattr(sys, "argv", [path, "--device", "cpu"])
    runpy.run_path(path, run_name="__main__")
    return capsys.readouterr().out


def test_basic_example(capsys, monkeypatch):
    out = _run("torch_basic.py", capsys, monkeypatch)
    assert "edges:" in out and "sweep edge counts" in out and "batched:" in out


def test_custom_source_example(capsys, monkeypatch):
    out = _run("torch_custom_source.py", capsys, monkeypatch)
    assert "processed 30 frames" in out


def test_sharded_example(capsys, monkeypatch):
    out = _run("torch_sharded_megaframe.py", capsys, monkeypatch)
    assert "sharded edge maps:" in out and "(2, 512, 1920)" in out


def test_live_controls_example(capsys, monkeypatch):
    out = _run("torch_live_controls.py", capsys, monkeypatch)
    assert "thresholds -> 40/160" in out
    assert "paused: True" in out
    assert "processed" in out


@pytest.mark.parametrize("name", ["torch_basic.py", "torch_custom_source.py",
                                  "torch_sharded_megaframe.py", "torch_live_controls.py"])
def test_examples_raise_without_a_card(monkeypatch, name):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    path = os.path.join(EXAMPLES, name)
    monkeypatch.setattr(sys, "argv", [path])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        runpy.run_path(path, run_name="__main__")
