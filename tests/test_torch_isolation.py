"""The port stands apart from the JAX package: no module of
alacjax_torch (nor chip_smoke.py) imports jax or any alacjax module, and
the port's own copies of alacjax's host modules (types, oracle, native
codec) behave as their originals do.

The copies are held to the originals on numpy inputs from a seed:
AlacConfig, the constants and ElementTag field for field; the scalar
oracle's packets and samples on stereo-16, 24-bit 5.1 and partial
frames; the native C++ codec's packets and samples (the port's copy
builds with g++ into build/alacjax_torch/native/ under a file lock).
"""

import ast
import dataclasses
import pathlib
import subprocess
import sys

import numpy as np
import pytest

import alacjax.types as jtypes
from alacjax import native as jnative
from alacjax import oracle as joracle
from alacjax_torch import native as tnative
from alacjax_torch import oracle as toracle
from alacjax_torch import types as ttypes
from conftest import gen_pcm

REPO = pathlib.Path(__file__).resolve().parents[1]
PKG = REPO / "alacjax_torch"
SOURCES = sorted(PKG.rglob("*.py")) + [REPO / "chip_smoke.py"]


def _foreign(name: str) -> bool:
    """True for jax and for alacjax or any of its modules (alacjax_torch
    is the port itself)."""
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "alacjax")


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(REPO)))
def test_source_imports_nothing_of_alacjax_or_jax(path):
    bad = [name for name in _imports(path) if _foreign(name)]
    assert not bad, (path, bad)


def test_every_module_imports_with_alacjax_and_jax_blocked():
    """Each module of the package, and chip_smoke.py, imports in a
    process where importing alacjax or jax fails."""
    mods = sorted(".".join(p.relative_to(REPO).with_suffix("").parts)
                  .removesuffix(".__init__") for p in PKG.rglob("*.py"))
    code = ("import importlib, sys\n"
            "for m in ('alacjax', 'jax', 'jaxlib'):\n"
            "    sys.modules[m] = None\n"
            f"for m in {mods!r} + ['chip_smoke']:\n"
            "    importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if sys.modules[m] is not None and\n"
            "       m.split('.')[0] in ('alacjax', 'jax', 'jaxlib')]\n"
            "print(len(sys.modules), bad)\n"
            "sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


# ---------------------------------------------------------------------------
# the copies against their originals
# ---------------------------------------------------------------------------
def test_types_equal_alacjax_field_for_field():
    names = [n for n in vars(ttypes) if not n.startswith("_")
             and n not in ("annotations", "dataclasses", "enum")]
    assert len(names) > 40
    for name in names:
        mine, theirs = getattr(ttypes, name), getattr(jtypes, name)
        if isinstance(mine, type) or callable(mine):
            continue
        assert mine == theirs, name
    assert ([(t.name, t.value) for t in ttypes.ElementTag]
            == [(t.name, t.value) for t in jtypes.ElementTag])
    assert ({n: [(int(t), w) for t, w in v]
             for n, v in ttypes.ELEMENT_LAYOUTS.items()}
            == {n: [(int(t), w) for t, w in v]
                for n, v in jtypes.ELEMENT_LAYOUTS.items()})
    fields = [(f.name, f.default) for f in dataclasses.fields(ttypes.AlacConfig)]
    assert fields == [(f.name, f.default)
                      for f in dataclasses.fields(jtypes.AlacConfig)]
    for kw in (dict(), dict(bit_depth=24, num_channels=6, frame_length=1000),
               dict(bit_depth=32, num_channels=8, fast_mode=True)):
        a, b = ttypes.AlacConfig(**kw), jtypes.AlacConfig(**kw)
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
        assert a.max_escape_packet_bytes() == b.max_escape_packet_bytes()
        assert a.channel_layout_tag == b.channel_layout_tag
    for kw in (dict(bit_depth=18), dict(num_channels=9), dict(search="x")):
        with pytest.raises(ttypes.AlacParamError):
            ttypes.AlacConfig(**kw)
    for v in (0, 1, 5, 0x7FFF, 0x8000, 0xFFFFFFFF, 123456789):
        assert ttypes.lead(v) == jtypes.lead(v)
        assert ttypes.lg3a(v) == jtypes.lg3a(v)
        assert ttypes.sign_extend(v, 16) == jtypes.sign_extend(v, 16)


# (depth, channels, samples per frame, frames, partial sample counts)
ORACLE_CASES = {
    "stereo16": (16, 2, 256, ["sine", "noise", "impulse", "silence"], {}),
    "surround24": (24, 6, 128, ["sine", "impulse", "noise"], {}),
    "partial20": (20, 3, 200, ["sine", "sine", "impulse"], {0: 77, 2: 1}),
}


def _frames(case, seed):
    depth, nch, S, kinds, partial = ORACLE_CASES[case]
    rng = np.random.default_rng(seed)
    pcm = [gen_pcm(rng, k, nch, S, depth) for k in kinds]
    return depth, nch, S, [f[:, :partial.get(i, S)] for i, f in enumerate(pcm)]


@pytest.mark.parametrize("case", list(ORACLE_CASES))
def test_oracle_copy_equals_alacjax_oracle(case):
    depth, nch, S, frames = _frames(case, 31)
    kw = dict(bit_depth=depth, num_channels=nch, frame_length=S)
    tcfg, jcfg = ttypes.AlacConfig(**kw), jtypes.AlacConfig(**kw)
    for independent in (True, False):
        tenc = toracle.ALACEncoder(tcfg, independent_frames=independent)
        jenc = joracle.ALACEncoder(jcfg, independent_frames=independent)
        packets = [tenc.encode_packet(f) for f in frames]
        assert packets == [jenc.encode_packet(f) for f in frames]
        assert tenc.get_magic_cookie() == jenc.get_magic_cookie()
    tdec = toracle.ALACDecoder(tenc.get_magic_cookie())
    jdec = joracle.ALACDecoder(jcfg)
    for f, p in zip(frames, packets):
        got, n = tdec.decode_packet(p)
        want, m = jdec.decode_packet(p)
        assert n == m == f.shape[1]
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, f)


@pytest.mark.parametrize("case", list(ORACLE_CASES))
def test_native_copy_equals_alacjax_native(case):
    if not jnative.available():
        pytest.skip(f"alacjax's native codec does not build: "
                    f"{jnative.build_error()}")
    assert tnative.available(), tnative.build_error()
    assert pathlib.Path(tnative._lib_path()).is_file()
    depth, nch, S, frames = _frames(case, 32)
    kw = dict(bit_depth=depth, num_channels=nch, frame_length=S)
    tcfg, jcfg = ttypes.AlacConfig(**kw), jtypes.AlacConfig(**kw)
    for search in ("standard", "exhaustive"):
        tenc = tnative.NativeEncoder(tcfg, independent_frames=True,
                                     search=search)
        jenc = jnative.NativeEncoder(jcfg, independent_frames=True,
                                     search=search)
        packets = [tenc.encode_packet(f) for f in frames]
        assert packets == [jenc.encode_packet(f) for f in frames]
    oracle = toracle.ALACEncoder(tcfg, independent_frames=True,
                                 search="exhaustive")
    assert packets == [oracle.encode_packet(f) for f in frames]
    tdec, jdec = tnative.NativeDecoder(tcfg), jnative.NativeDecoder(jcfg)
    for f, p in zip(frames, packets):
        got, n = tdec.decode_packet(p)
        want, m = jdec.decode_packet(p)
        assert n == m == f.shape[1]
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, f)
