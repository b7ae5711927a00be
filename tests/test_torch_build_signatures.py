"""The ctypes signatures of the kernel library (``ops/cuda/_build.py``,
``SIGNATURES``) against the ``extern "C"`` entry points of ``csrc/*.cu``.

The library is built and called only on a host with a card, where a
signature that passes one argument too few, or a pointer as a 32-bit int,
fails at run time or corrupts arguments. Here each entry point's
declaration is parsed from its source: every name in ``SIGNATURES`` is
declared once, with the same number of parameters, each of the ctypes type
its C type takes (a pointer as ``c_void_p``, ``int`` as ``c_int``, ``long
long`` as ``c_longlong``), and the same return type.
"""
from __future__ import annotations

import ctypes
import re

import pytest

from cudacam_tpu_torch.ops.cuda._build import CSRC_DIR, SIGNATURES

_DECL = re.compile(r'extern\s+"C"\s+([\w\s\*]+?)\s*\b(cc_\w+)\s*\(([^)]*)\)', re.S)


def _ctype(c: str):
    c = " ".join(c.replace("*", " * ").split())
    if c.endswith("char *"):
        return ctypes.c_char_p
    if "*" in c:
        return ctypes.c_void_p
    if c in ("int", "const int"):
        return ctypes.c_int
    if c in ("long long", "const long long"):
        return ctypes.c_longlong
    raise AssertionError(f"no ctypes mapping for C type {c!r}")


def _declarations() -> dict:
    found = {}
    for src in sorted(CSRC_DIR.glob("*.cu")):
        for ret, name, params in _DECL.findall(src.read_text()):
            assert name not in found, f"{name} declared twice"
            types = [re.sub(r"\w+\s*$", "", p) for p in params.split(",") if p.strip()]
            found[name] = (_ctype(ret), [_ctype(t) for t in types])
    return found


DECLS = _declarations()


@pytest.mark.parametrize("name", sorted(SIGNATURES))
def test_signature_matches_the_c_declaration(name):
    assert name in DECLS, f"{name} has no extern \"C\" declaration in csrc"
    restype, argtypes = SIGNATURES[name]
    want_ret, want_args = DECLS[name]
    assert restype is want_ret
    assert len(argtypes) == len(want_args), (len(argtypes), len(want_args))
    assert [a.__name__ for a in argtypes] == [a.__name__ for a in want_args]


def test_every_entry_point_has_a_signature():
    assert sorted(DECLS) == sorted(SIGNATURES)


def _out_indices(name: str) -> list:
    """The indices of ``out[i] = ...`` in the body of entry point ``name``."""
    for src in sorted(CSRC_DIR.glob("*.cu")):
        text = src.read_text()
        head = re.search(r'extern\s+"C"\s+int\s+' + name + r'\s*\(', text)
        if head:
            body = text[head.end():text.index("\n}\n", head.end())]
            return sorted(int(i) for i in re.findall(r"\bout\[(\d+)\]\s*=", body))
    raise AssertionError(f"{name} not found in csrc")


@pytest.mark.parametrize("name,keys", [("cc_hyst_layout", 6),
                                       ("cc_sharded_loop_layout", "LOOP_LAYOUT_KEYS"),
                                       ("cc_split_layout", "SPLIT_LAYOUT_KEYS"),
                                       ("cc_probe_loop_layout", "PROBE_LOOP_LAYOUT_KEYS"),
                                       ("cc_probe_ballot_grid", 4),
                                       ("cc_probe_pack_layout", "PROBE_PACK_LAYOUT_KEYS"),
                                       ("cc_probe_unpack_layout", "PROBE_UNPACK_LAYOUT_KEYS"),
                                       ("cc_swar_layout", "SWAR_LAYOUT_KEYS")])
def test_layout_reporter_fills_every_key_once(name, keys):
    """A layout reporter writes each int its Python reader allocates once,
    and none past it: ``round_layout`` reads 6, ``loop_layout`` one per
    ``LOOP_LAYOUT_KEYS`` entry, ``split_layout`` one per
    ``SPLIT_LAYOUT_KEYS`` entry, ``probe_loop_layout`` one per
    ``PROBE_LOOP_LAYOUT_KEYS`` entry, ``probe_pack_ballot_grid`` 4,
    ``probe_unpack_layout_cc`` one per ``PROBE_UNPACK_LAYOUT_KEYS`` entry,
    ``probe_pack_layout_cc`` one per ``PROBE_PACK_LAYOUT_KEYS`` entry,
    ``swar_layout_cc`` one per ``SWAR_LAYOUT_KEYS`` entry."""
    from cudacam_tpu_torch.ops.cuda import megakernel
    from cudacam_tpu_torch.probes import hyster_kernel, i16_swar

    if isinstance(keys, str):
        keys = len(next(getattr(m, keys) for m in (megakernel, hyster_kernel, i16_swar)
                        if hasattr(m, keys)))
    assert _out_indices(name) == list(range(keys))


def _params(name: str) -> list:
    """(C type, parameter name) of entry point ``name``'s declaration."""
    for src in sorted(CSRC_DIR.glob("*.cu")):
        for _, found, params in _DECL.findall(src.read_text()):
            if found == name:
                return [tuple(p.rsplit(None, 1)) for p in " ".join(params.split()).split(",")]
    raise AssertionError(f"{name} not found in csrc")


@pytest.mark.parametrize("name,after", [("cc_hyst_phase1", "flags"), ("cc_hyst_phase2", "flags"),
                                        ("cc_sharded_loop", "rounds")])
def test_round_entry_points_take_their_counter_slot(name, after):
    """The main path's round kernels take the address of their two 64-bit
    round counters (``_build.round_slot``, null for none) right after the
    flags (the loop: after the rounds it writes), a pointer in
    ``SIGNATURES``."""
    params = _params(name)
    names = [p[1].lstrip("*") for p in params]
    i = names.index("count")
    assert names[i - 1] == after and "*" in " ".join(params[i])
    assert SIGNATURES[name][1][i] is ctypes.c_void_p
