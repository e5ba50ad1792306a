"""The port's format registry against the JAX package's: ``fourcc``,
``register_format``, ``register_codec`` and ``is_implemented`` (the
counterpart of ``YUV::isImplementedFormat``, myyuv_yuv.cpp:264-276) give the
same answers for the same registrations, on every (fourcc, compression)
pair of the known formats and compressions and of a format registered
here. Both packages' tables are restored after each test.

Tolerance: exact equality."""

import pytest

import myyuv_tpu
import myyuv_tpu_torch
from myyuv_tpu.formats import yuv as jyuv
from myyuv_tpu_torch.formats import yuv as pyuv

TABLES = ("FORMATS", "BMP_TO_YUV", "COMPRESSORS", "DECOMPRESSORS")
NV12 = pyuv.fourcc("NV12")


@pytest.fixture
def registries():
    """Both packages' registries, emptied of converters and codecs (the
    port's state at import), restored afterwards."""
    saved = [(mod, name, dict(getattr(mod, name)))
             for mod in (jyuv, pyuv) for name in TABLES]
    for mod in (jyuv, pyuv):
        for name in TABLES[1:]:
            getattr(mod, name).clear()
    yield
    for mod, name, table in saved:
        getattr(mod, name).clear()
        getattr(mod, name).update(table)


def _answers(mod):
    fccs = (mod.FourccFormats.UNKNOWN, mod.FourccFormats.IYUV, NV12)
    comps = (mod.Compressions.NONE, mod.Compressions.DCT, 7)
    return {(f, c): mod.is_implemented(f, c) for f in fccs for c in comps}


def _nv12(mod):
    if mod is jyuv:
        return jyuv.FormatDescriptor(
            fourcc=NV12, name="NV12", group=jyuv.FormatGroup.SEMI_PLANAR,
            plane_order=(0, 1, 2, jyuv.NO_PLANE), resolution_fraction=(2, 2))
    return pyuv.FormatDescriptor(
        fourcc=NV12, name="NV12", group=pyuv.FormatGroup.SEMI_PLANAR,
        num_planes=3, resolution_fraction=(2, 2))


def _convert(bmp):
    return None


def _codec(*args):
    return None


# each step registers the same thing in both packages
STEPS = {
    "nothing": lambda mod: None,
    "iyuv_converter": lambda mod: mod.BMP_TO_YUV.__setitem__(
        mod.FourccFormats.IYUV, _convert),
    "dct_codec": lambda mod: mod.register_codec(
        mod.Compressions.DCT, mod.FourccFormats.IYUV, _codec, _codec),
    "compressor_alone": lambda mod: mod.COMPRESSORS.__setitem__(
        (7, mod.FourccFormats.IYUV), _codec),
    "nv12_format": lambda mod: mod.register_format(_nv12(mod)),
    "nv12_converter": lambda mod: mod.register_format(
        _nv12(mod), bmp_to_yuv=_convert),
    "nv12_dct_codec": lambda mod: mod.register_codec(
        mod.Compressions.DCT, NV12, _codec, _codec),
}


def test_exports_match_the_jax_package():
    for name in ("fourcc", "is_implemented", "FourccFormats",
                 "Compressions"):
        assert name in myyuv_tpu_torch.__all__ and name in myyuv_tpu.__all__
    for code in ("IYUV", "NV12", "YUY2", "\0\0\0\0"):
        assert myyuv_tpu_torch.fourcc(code) == myyuv_tpu.fourcc(code)
    assert myyuv_tpu_torch.is_implemented is pyuv.is_implemented


@pytest.mark.parametrize("order", [list(STEPS), list(STEPS)[::-1]])
def test_is_implemented_matches_the_jax_package(registries, order):
    """After each step, in both orders, every answer is the JAX package's."""
    for step in order:
        for mod in (jyuv, pyuv):
            STEPS[step](mod)
        assert _answers(pyuv) == _answers(jyuv), step


def test_engine_codecs_make_iyuv_dct_implemented(registries):
    """The port's engine registration answers as the JAX package's import
    does: IYUV with and without DCT, no other pair."""
    from myyuv_tpu.engine import host_codec
    from myyuv_tpu_torch.engine import pipeline
    pipeline.register_engine_codecs("cpu")
    host_codec.register_host_codecs()
    assert _answers(pyuv) == _answers(jyuv)
    assert [k for k, v in _answers(pyuv).items() if v] == [
        (pyuv.FourccFormats.IYUV, pyuv.Compressions.NONE),
        (pyuv.FourccFormats.IYUV, pyuv.Compressions.DCT)]


def test_answers_follow_the_reference_rule(registries):
    """An unregistered converter answers False whatever the codec; NONE
    needs only the converter; another compression both halves."""
    iyuv, dct = pyuv.FourccFormats.IYUV, pyuv.Compressions.DCT
    assert not pyuv.is_implemented(iyuv)
    pyuv.register_codec(dct, iyuv, _codec, _codec)
    assert not pyuv.is_implemented(iyuv, dct)
    pyuv.BMP_TO_YUV[iyuv] = _convert
    assert pyuv.is_implemented(iyuv) and pyuv.is_implemented(iyuv, dct)
    del pyuv.DECOMPRESSORS[(dct, iyuv)]
    assert not pyuv.is_implemented(iyuv, dct)
    pyuv.register_format(_nv12(pyuv), bmp_to_yuv=_convert)
    assert pyuv.FORMATS[NV12].name == "NV12" and pyuv.is_implemented(NV12)
