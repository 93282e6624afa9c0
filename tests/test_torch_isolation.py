"""The port stands apart from the JAX package: no module of
alacjax_torch (nor chip_smoke.py, the port's tools/torch_*.py or its
bench*_torch.py scripts) imports jax or any alacjax module, and the
port's own copies of alacjax's host modules (types, bitbuffer, oracle,
native codec) behave as their originals do and lack none of their
public names.  The package exports every public name of alacjax's from
those copies, and importing it builds nothing.

The copies are held to the originals on numpy inputs from a seed:
AlacConfig, the constants and ElementTag field for field; the scalar
oracle's packets and samples on stereo-16, 24-bit 5.1 and partial
frames; the native C++ codec's packets and samples (the port's copy
builds with g++ into build/alacjax_torch/native/ under a file lock).
"""

import __future__
import ast
import dataclasses
import enum
import importlib
import inspect
import pathlib
import subprocess
import sys

import numpy as np
import pytest

import alacjax
import alacjax.types as jtypes
import alacjax_torch
from alacjax import native as jnative
from alacjax import oracle as joracle
from alacjax.bitbuffer import BitBuffer as JBitBuffer
from alacjax_torch import native as tnative
from alacjax_torch import oracle as toracle
from alacjax_torch import types as ttypes
from conftest import gen_pcm

REPO = pathlib.Path(__file__).resolve().parents[1]
PKG = REPO / "alacjax_torch"
TOOLS = sorted((REPO / "tools").glob("torch_*.py"))
BENCHES = [REPO / f"bench{b}_torch.py"
           for b in ("", "_configs", "_compression")]
SOURCES = (sorted(PKG.rglob("*.py")) + [REPO / "chip_smoke.py"] + TOOLS
           + BENCHES)


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
    """Each module of the package, chip_smoke.py, the port's tools and
    its bench scripts import in a process where importing alacjax or jax
    fails."""
    mods = sorted(".".join(p.relative_to(REPO).with_suffix("").parts)
                  .removesuffix(".__init__") for p in PKG.rglob("*.py"))
    code = ("import importlib, sys\n"
            "for m in ('alacjax', 'jax', 'jaxlib'):\n"
            "    sys.modules[m] = None\n"
            "sys.path.insert(0, 'tools')\n"
            f"for m in {mods!r} + ['chip_smoke'] + "
            f"{[p.stem for p in TOOLS + BENCHES]!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if sys.modules[m] is not None and\n"
            "       m.split('.')[0] in ('alacjax', 'jax', 'jaxlib')]\n"
            "print(len(sys.modules), bad)\n"
            "sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_package_exports_every_public_name_of_alacjax():
    """alacjax's __all__ is a subset of the port's, each name the port's
    own object (defined in alacjax_torch), beside the port's own
    names."""
    assert set(alacjax.__all__) <= set(alacjax_torch.__all__)
    for name in alacjax_torch.__all__:
        obj = getattr(alacjax_torch, name)
        if name == "__version__":
            assert obj == alacjax.__version__
            continue
        assert obj.__module__.startswith("alacjax_torch."), (name, obj)
    for name in ("TorchCodec", "get_codec", "ShardedCodec", "encode_streams",
                 "encode_stream_device"):
        assert name in alacjax_torch.__all__
    assert alacjax_torch.BitBuffer is alacjax_torch.bitbuffer.BitBuffer
    assert (alacjax_torch.parse_cookie(alacjax_torch.serialize_cookie(
        alacjax_torch.AlacConfig(num_channels=6)))
        == alacjax_torch.AlacConfig(num_channels=6))


def test_package_import_builds_nothing():
    """Importing the package (the oracle included) loads neither the
    native codec nor the CUDA kernels' library."""
    code = ("import sys\n"
            "import alacjax_torch\n"
            "from alacjax_torch import ALACEncoder, ALACDecoder\n"
            "from alacjax_torch.kernels import _build\n"
            "assert 'alacjax_torch.native' not in sys.modules\n"
            "assert _build._lib is None and _build._path is None\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


# ---------------------------------------------------------------------------
# the copies against their originals
# ---------------------------------------------------------------------------
def _bitbuffer_ops(seed):
    """A seeded byte buffer and a seeded sequence of cursor operations
    over it (reads, small reads, single bits, peeks, rewinds, advances,
    resets), every read inside the buffer."""
    rng = np.random.default_rng(seed)
    data = rng.integers(0, 256, int(rng.integers(8, 64)),
                        dtype=np.uint8).tobytes()
    total, pos, ops = len(data) * 8, 0, []
    for _ in range(200):
        kind = ["read", "read_small", "read_one", "peek", "rewind",
                "advance", "reset"][int(rng.integers(0, 7))]
        if kind == "reset":
            ops.append((kind, ()))
            pos = 0
            continue
        if kind == "rewind":
            n = int(rng.integers(0, pos + 1))
            ops.append((kind, (n,)))
            pos -= n
            continue
        n = 1 if kind == "read_one" else int(rng.integers(
            0, (16 if kind == "read_small" else 32) + 1))
        if pos + n > total:
            continue
        ops.append((kind, () if kind == "read_one" else (n,)))
        pos += 0 if kind == "peek" else n
    return data, ops


@pytest.mark.parametrize("seed", range(6))
def test_bitbuffer_copy_equals_alacjax_bitbuffer(seed):
    """rewind, reset, read_small, read_one and peek (beside read and
    advance): on the same bytes, every call returns what alacjax's
    BitBuffer returns and leaves the same bitpos."""
    data, ops = _bitbuffer_ops(seed)
    mine, theirs = alacjax_torch.BitBuffer(data), JBitBuffer(data)
    used = set()
    for kind, args in ops:
        assert (getattr(mine, kind)(*args)
                == getattr(theirs, kind)(*args)), (kind, args)
        assert mine.bitpos == theirs.bitpos, (kind, args)
        used.add(kind)
    assert {"rewind", "reset", "read_small", "read_one", "peek"} <= used
    for kind in ("read_small", "peek"):
        for bb in (mine, theirs):
            bb.set_position(len(data) * 8 - 3)
        with pytest.raises(ttypes.AlacParamError):
            getattr(mine, kind)(4)
        with pytest.raises(jtypes.AlacParamError):
            getattr(theirs, kind)(4)
        assert mine.bitpos == theirs.bitpos == len(data) * 8 - 3


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


def _public(mod) -> dict:
    """A module's public names (its ``__all__`` where it has one), less
    the modules and the ``__future__`` feature it imports."""
    names = getattr(mod, "__all__", None) or [
        n for n in vars(mod) if not n.startswith("_")]
    feature = type(__future__.annotations)
    return {n: getattr(mod, n) for n in names
            if not inspect.ismodule(getattr(mod, n))
            and not isinstance(getattr(mod, n), feature)}


@pytest.mark.parametrize("mod", ["types", "oracle", "oracle.ag"])
def test_port_lacks_no_public_name_of_alacjax(mod):
    """The other way round from the field-for-field checks: every public
    name of alacjax's module (``__all__`` for the oracle package) is in
    the port's copy, a constant with an equal value, an enum or
    dataclass with equal members or fields, anything else by name.
    None of these three modules holds jax or TPU machinery, so none is
    excused."""
    orig = importlib.import_module(f"alacjax.{mod}")
    mine = importlib.import_module(f"alacjax_torch.{mod}")
    theirs = _public(orig)
    missing = sorted(n for n in theirs if not hasattr(mine, n))
    assert not missing, missing
    if hasattr(orig, "__all__"):
        assert set(orig.__all__) <= set(mine.__all__)
    for name, want in theirs.items():
        got = getattr(mine, name)
        if isinstance(want, enum.EnumMeta):
            assert [(t.name, t.value) for t in got] == [
                (t.name, t.value) for t in want], name
        elif dataclasses.is_dataclass(want):
            assert ([f.name for f in dataclasses.fields(got)]
                    == [f.name for f in dataclasses.fields(want)]), name
        elif not callable(want):
            assert got == want, name
    if mod != "types":
        for fw, sw in ((4096, 4096), (256, 256), (1000, 7)):
            assert (dataclasses.asdict(mine.set_standard_ag_params(fw, sw))
                    == dataclasses.asdict(orig.set_standard_ag_params(fw, sw)))


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
