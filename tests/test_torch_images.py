"""The port's still-image surface against Pillow and vrgdg_tpu, on the CPU:
the image reader, writer and LANCZOS resize
(vrgdg_tpu_torch.runtime.image_io), the image appliers and previews, the
compare of two images, the LUT catalog and adjust presets, and the
``lut``/``adjust``/``compare``/``luts``/``make-lut`` commands.

Pillow is used here only, as the reference of the cv2 rules: decoded
pixels equal (EXIF orientation ignored by ``read_rgb``, applied by
``read_rgb_exif_transposed``), JPEG bytes equal at quality 75, WebP equal
decoded at quality 80, PNG/BMP lossless, and Pillow's LANCZOS resize bit
for bit, and 16-bit PNGs of all four colour types as Pillow reads them
(a gray one clipped at 255, the others' high byte).

Outputs against the JAX package's, decoded: PNG round trips (identity
adjust), the identity LUT (its lerps round as XLA's fused multiply-adds)
and the selection compare modes are exact; LUT, adjust and the blend
compare modes within one level on at most 0.1% of values.  The grain
streams differ by design (Philox against threefry), so the grain image is
held to its determinism and to the JAX output's noise level.
"""

import glob
import json
import os
import re
import struct
import zlib

import numpy as np
import pytest
import torch
from PIL import Image, ImageOps

import jax.numpy as jnp

cv2 = pytest.importorskip("cv2")

import vrgdg_tpu.api as japi
from vrgdg_tpu.api import paths as jpaths
from vrgdg_tpu.core.cube import parse_cube as jparse_cube
from vrgdg_tpu.core.params import LUTParams as JLUTParams
from vrgdg_tpu.ops.grade import GradeConfig as JConfig
from vrgdg_tpu.ops.grade import grade as jgrade
from vrgdg_tpu_torch import api as tapi
from vrgdg_tpu_torch import cli
from vrgdg_tpu_torch.api import appliers as tap
from vrgdg_tpu_torch.api import paths as tpaths
from vrgdg_tpu_torch.runtime import image_io

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LUTS = os.path.join(REPO, "LUTS")
EXAMPLES = sorted(glob.glob(os.path.join(LUTS, "examples", "*.jpg")))
ADJUST = {"contrast": 20, "saturation": -10, "vignette": 30,
          "temperature": 15}


def _noise(seed, shape):
    return np.random.default_rng(seed).integers(0, 256, shape, np.uint8)


def _smooth(height, width):
    yy, xx = np.mgrid[0:height, 0:width]
    return np.stack([xx * 255 // max(width - 1, 1),
                     yy * 255 // max(height - 1, 1),
                     (xx + yy) % 256], -1).astype(np.uint8)


def _pil(path, transpose=False):
    with Image.open(path) as image:
        if transpose:
            image = ImageOps.exif_transpose(image)
        return np.asarray(image.convert("RGB"))


def _decoded(path):
    return _pil(path).astype(np.int16)


def _within_one_level(got, want, share=1e-3):
    diff = np.abs(_decoded(got) - _decoded(want))
    assert diff.max() <= 1 and (diff > 0).mean() <= share, \
        (int(diff.max()), float((diff > 0).mean()))


# --------------------------------------------------------------------------
# image_io against Pillow
# --------------------------------------------------------------------------

@pytest.mark.parametrize("src,dst", [((300, 500), (180, 320)),
                                     ((90, 160), (270, 480)),
                                     ((101, 77), (64, 200)),
                                     ((270, 480), (271, 479)),
                                     ((37, 53), (5, 3)),
                                     ((1, 7), (3, 2))])
@pytest.mark.parametrize("content", ["noise", "smooth"])
def test_lanczos_resize_is_pillow_bit_for_bit(src, dst, content):
    image = _noise(3, (*src, 3)) if content == "noise" else _smooth(*src)
    got = image_io.pil_lanczos_resize(image, dst[1], dst[0])
    want = np.asarray(Image.fromarray(image).resize((dst[1], dst[0]),
                                                    Image.LANCZOS))
    np.testing.assert_array_equal(got, want)


def test_lanczos_resize_equal_size_is_a_copy():
    image = _noise(4, (9, 11, 3))
    out = image_io.pil_lanczos_resize(image, 11, 9)
    np.testing.assert_array_equal(out, image)
    assert out is not image
    with pytest.raises(ValueError):
        image_io.pil_lanczos_resize(image.astype(np.float32), 4, 4)


def _save_mode(path, mode):
    rgb = _noise(5, (37, 53, 3))
    if mode == "RGB":
        Image.fromarray(rgb).save(path)
    elif mode == "RGBA":
        Image.fromarray(np.dstack([rgb, _noise(6, (37, 53))])).save(path)
    elif mode == "L":
        Image.fromarray(rgb[..., 0]).save(path)
    elif mode == "P":
        Image.fromarray(rgb).quantize(64).save(path)
    elif mode == "P+transparency":
        Image.fromarray(rgb).quantize(16).save(path, transparency=3)
    elif mode == "1":
        Image.fromarray(rgb[..., 0]).convert("1").save(path)
    elif mode == "RGB;16":
        cv2.imwrite(path, np.random.default_rng(7).integers(
            0, 65536, (37, 53, 3)).astype(np.uint16))


@pytest.mark.parametrize("mode", ["RGB", "RGBA", "L", "P", "P+transparency",
                                  "1", "RGB;16"])
def test_read_png_modes_as_pillow(tmp_path, mode):
    path = str(tmp_path / "image.png")
    _save_mode(path, mode)
    want = _pil(path)
    np.testing.assert_array_equal(image_io.read_rgb(path), want)
    np.testing.assert_array_equal(image_io.read_rgb_exif_transposed(path),
                                  _pil(path, transpose=True))


def _png16(path, values, color_type):
    """A 16-bit PNG of ``values`` (H, W, channels) in the given IHDR colour
    type, written with zlib (Pillow cannot write all four types)."""
    height, width = values.shape[:2]
    rows = b"".join(b"\x00" + values[y].astype(">u2").tobytes()
                    for y in range(height))

    def chunk(kind, data):
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))

    header = struct.pack(">IIBBBBB", width, height, 16, color_type, 0, 0, 0)
    with open(path, "wb") as handle:
        handle.write(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", header)
                     + chunk(b"IDAT", zlib.compress(rows)) + chunk(b"IEND", b""))


@pytest.mark.parametrize("color_type,channels",
                         [(0, 1), (4, 2), (2, 3), (6, 4)],
                         ids=["gray", "gray_alpha", "rgb", "rgba"])
def test_read_16bit_gray_png_matches_pillow(tmp_path, color_type, channels):
    """Pillow opens a 16-bit gray PNG as I;16 and clips at 255 on
    convert("RGB"); the other 16-bit types keep each value's high byte."""
    path = str(tmp_path / "image16.png")
    values = np.random.default_rng(color_type).integers(
        0, 65536, (16, 20, channels)).astype(np.uint16)
    # the edges of both rules: 255/256, the high-byte steps, the extremes
    values[0, :, 0] = [0, 1, 127, 128, 255, 256, 257, 383, 384, 511, 512,
                       1000, 32767, 32768, 40000, 65279, 65280, 65535, 200,
                       300]
    _png16(path, values, color_type)
    np.testing.assert_array_equal(image_io.read_rgb(path), _pil(path))
    np.testing.assert_array_equal(image_io.read_rgb_exif_transposed(path),
                                  _pil(path, transpose=True))


@pytest.mark.parametrize("path", EXAMPLES, ids=os.path.basename)
def test_read_bundled_examples_as_pillow(path):
    assert len(EXAMPLES) == 18
    np.testing.assert_array_equal(image_io.read_rgb(path), _pil(path))


def test_exif_orientation_under_both_rules(tmp_path):
    path = str(tmp_path / "rotated.jpg")
    exif = Image.Exif()
    exif[0x0112] = 6
    Image.fromarray(_noise(8, (40, 64, 3))).save(path, exif=exif)
    plain = image_io.read_rgb(path)
    turned = image_io.read_rgb_exif_transposed(path)
    assert plain.shape == (40, 64, 3) and turned.shape == (64, 40, 3)
    np.testing.assert_array_equal(plain, _pil(path))
    np.testing.assert_array_equal(turned, _pil(path, transpose=True))


@pytest.mark.parametrize("ext", [".jpg", ".jpeg", ".webp", ".png", ".bmp"])
@pytest.mark.parametrize("content", ["noise", "smooth"])
def test_write_matches_pillow_defaults(tmp_path, ext, content):
    image = _noise(9, (120, 160, 3)) if content == "noise" \
        else _smooth(120, 160)
    ours, theirs = str(tmp_path / f"t{ext}"), str(tmp_path / f"p{ext}")
    image_io.write_rgb(ours, image)
    Image.fromarray(image).save(theirs)
    np.testing.assert_array_equal(_pil(ours), _pil(theirs))
    if ext in (".jpg", ".jpeg", ".webp"):
        with open(ours, "rb") as a, open(theirs, "rb") as b:
            assert a.read() == b.read()
    else:
        np.testing.assert_array_equal(_pil(ours), image)


def test_read_and_write_refuse_bad_input(tmp_path):
    text = tmp_path / "notes.png"
    text.write_text("not an image")
    with pytest.raises(ValueError, match="notes.png"):
        image_io.read_rgb(str(text))
    with pytest.raises(ValueError, match="uint8"):
        image_io.write_rgb(str(tmp_path / "x.png"),
                           np.zeros((4, 4, 3), np.float32))
    with pytest.raises((RuntimeError, cv2.error)):
        image_io.write_rgb(str(tmp_path / "x.unknown"),
                           np.zeros((4, 4, 3), np.uint8))


# --------------------------------------------------------------------------
# the image appliers and previews against the JAX package
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def image(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("images") / "frame.png")
    Image.fromarray(_noise(10, (90, 160, 3))).save(path)
    return path


def _both(name, image, tmp_path, *args, **kwargs):
    want = getattr(japi, name)(image, *args[:1], str(tmp_path / "j.png"),
                               *args[1:], **kwargs)
    got = getattr(tap, name)(image, *args[:1], str(tmp_path / "t.png"),
                             *args[1:], device="cpu", **kwargs)
    assert set(got) == set(want) | {"stage_seconds"}
    assert set(got["stage_seconds"]) == {"decode", "device", "encode"}
    assert got["device"] == "cpu"
    return got["output"], want["output"]


def test_teal_orange_lut_image_matches_jax(image, tmp_path):
    _within_one_level(*_both("apply_lut_to_image", image, tmp_path,
                             "teal_orange.cube", 7.0))


def test_identity_lut_image_matches_jax(image, tmp_path):
    got, want = _both("apply_lut_to_image", image, tmp_path, "identity.cube",
                      7.0)
    # JAX returns every input level, and so does the port
    np.testing.assert_array_equal(_decoded(want), _decoded(image))
    np.testing.assert_array_equal(_decoded(got), _decoded(want))
    # the lerps round as XLA's fused multiply-adds do: the floats are equal
    x = image_io.read_rgb(image).astype(np.float32)[None] / 255.0
    lut = jparse_cube(os.path.join(LUTS, "identity.cube"))
    jax_out = np.asarray(jgrade(x, JConfig(lut=JLUTParams.normalize(7.0)),
                                lut=lut))
    port_out = tap._lut_effect("identity.cube", 7.0, None, "cpu")[0](
        torch.from_numpy(x), 0).numpy()
    np.testing.assert_array_equal(port_out, jax_out)


def test_adjust_image_matches_jax(image, tmp_path):
    _within_one_level(*_both("apply_adjust_to_image", image, tmp_path,
                             settings=ADJUST))


def test_identity_adjust_is_an_exact_png_round_trip(image, tmp_path):
    got, want = _both("apply_adjust_to_image", image, tmp_path, settings={})
    np.testing.assert_array_equal(_pil(got), _pil(want))
    np.testing.assert_array_equal(_pil(got), _pil(image))


def test_grain_image_is_deterministic_at_the_jax_noise_level(tmp_path):
    path = str(tmp_path / "gray.png")
    Image.fromarray(np.full((64, 96, 3), 128, np.uint8)).save(path)
    kw = dict(grain_intensity=0.05, saturation_mix=0.5, seed=7)
    want = japi.apply_film_grain_to_image(path, str(tmp_path / "j.png"), **kw)
    got = tap.apply_film_grain_to_image(path, str(tmp_path / "t.png"),
                                        device="cpu", **kw)
    again = tap.apply_film_grain_to_image(path, str(tmp_path / "u.png"),
                                          device="cpu", **kw)
    with open(got["output"], "rb") as a, open(again["output"], "rb") as b:
        assert a.read() == b.read()
    assert {k: got[k] for k in kw} == {k: want[k] for k in kw}
    ours = (_decoded(got["output"]) - 128).reshape(-1, 3).std(0)
    theirs = (_decoded(want["output"]) - 128).reshape(-1, 3).std(0)
    assert np.all(np.abs(ours / theirs - 1) < 0.15), (ours, theirs)


def test_replace_source_writes_in_place(tmp_path):
    path = str(tmp_path / "frame.jpg")
    Image.fromarray(_noise(11, (30, 40, 3))).save(path)
    copy = str(tmp_path / "copy.jpg")
    with open(path, "rb") as src, open(copy, "wb") as dst:
        dst.write(src.read())
    got = tap.apply_adjust_to_image(path, settings=ADJUST,
                                    replace_source=True, device="cpu")
    want = japi.apply_adjust_to_image(copy, settings=ADJUST,
                                      replace_source=True)
    assert got["output"] == path and got["replace_source"] is True
    assert want["output"] == copy
    assert sorted(os.listdir(tmp_path)) == ["copy.jpg", "frame.jpg"]
    diff = np.abs(_decoded(path) - _decoded(copy))
    assert diff.max() <= 3  # JPEG of values one level apart


def test_default_output_path_and_refusals(image, tmp_path):
    got = tap.apply_lut_to_image(image, "teal_orange.cube", device="cpu")
    assert got["output"] == os.path.splitext(image)[0] + "_teal_orange.png"
    os.remove(got["output"])
    clip = tmp_path / "clip.mp4"
    clip.write_bytes(b"")
    with pytest.raises(ValueError, match="Input image type"):
        tap.apply_adjust_to_image(str(clip), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tap.apply_lut_to_image(image, "teal_orange.cube")


def _write_clip(path, frames=3, size=(64, 36)):
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 10.0,
                             size)
    for frame in range(frames):
        writer.write(_noise(12 + frame, (size[1], size[0], 3)))
    writer.release()
    return path


@pytest.mark.parametrize("source", ["image", "video"])
@pytest.mark.parametrize("preview", ["lut", "adjust", "grain"])
def test_previews_match_jax(image, tmp_path, source, preview):
    media = image if source == "image" else _write_clip(
        str(tmp_path / "clip.mp4"))
    calls = {
        "lut": ("preview_lut_on_media", ("teal_orange.cube", 7.0), {}),
        "adjust": ("preview_adjust_on_media", (ADJUST,), {}),
        "grain": ("preview_film_grain_on_media", (0.05, 0.5, 3), {}),
    }
    name, args, kw = calls[preview]
    want = getattr(japi, name)(media, *args, base=str(tmp_path / "j"), **kw)
    got = getattr(tap, name)(media, *args, base=str(tmp_path / "t"),
                             device="cpu", **kw)
    assert set(got) == {"before", "after"}
    folder = tpaths.preview_root(str(tmp_path / "t"))
    for key in ("before", "after"):
        assert os.path.dirname(got[key]) == folder
        assert re.fullmatch(r"preview_\d+_" + key + r"\.jpg",
                            os.path.basename(got[key]))
    # the same pixels through the same encoder: the same bytes
    with open(got["before"], "rb") as a, open(want["before"], "rb") as b:
        assert a.read() == b.read()
    if preview != "grain":
        with open(got["after"], "rb") as a, open(want["after"], "rb") as b:
            assert a.read() == b.read()
    assert _pil(got["after"]).shape == _pil(want["after"]).shape


def test_delete_preview_once(image, tmp_path):
    base = str(tmp_path / "out")
    made = tap.preview_adjust_on_media(image, ADJUST, base=base,
                                       device="cpu")
    assert tap.delete_preview(made["after"], base=base)
    assert not os.path.exists(made["after"])
    assert not tap.delete_preview(made["after"], base=base)
    assert not tap.delete_preview(image, base=base)
    assert os.path.isfile(made["before"])


# --------------------------------------------------------------------------
# compare_images against the JAX applier
# --------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["side_by_side", "slider", "overlay",
                                  "difference", "blink"])
@pytest.mark.parametrize("b_size", [(90, 160), (45, 70)])
def test_compare_images_match_jax(image, tmp_path, mode, b_size):
    other = str(tmp_path / "b.jpg")
    Image.fromarray(_noise(13, (*b_size, 3))).save(other)
    kw = dict(slider_position=0.3, overlay_opacity=0.7, difference_gain=3.0)
    want = japi.compare_images(image, other, mode, str(tmp_path / "j.png"),
                               **kw)
    got = tapi.compare_images(image, other, mode, str(tmp_path / "t.png"),
                              device="cpu", **kw)
    assert set(got) == set(want)
    for key in ("mode", "width", "height"):
        assert got[key] == want[key]
    assert got["width"] == (322 if mode in ("side_by_side", "blink")
                            else 160)
    if mode in ("side_by_side", "slider", "blink") and b_size == (90, 160):
        np.testing.assert_array_equal(_pil(got["output"]),
                                      _pil(want["output"]))
    else:
        _within_one_level(got["output"], want["output"])


# --------------------------------------------------------------------------
# the reference image of colour match reads as Pillow reads it
# --------------------------------------------------------------------------

def test_reference_image_ignores_exif_orientation(tmp_path):
    path = str(tmp_path / "ref.jpg")
    exif = Image.Exif()
    exif[0x0112] = 6
    Image.fromarray(_noise(14, (20, 30, 3))).save(path, exif=exif)
    got = tap._load_reference_image(path)
    want = np.asarray(Image.open(path).convert("RGB"), np.float32)[None] / 255.0
    assert got.shape == (1, 20, 30, 3)
    np.testing.assert_array_equal(got, want)


# --------------------------------------------------------------------------
# the LUT catalog and adjust presets are copies of the originals
# --------------------------------------------------------------------------

def _no_times(value):
    if isinstance(value, dict):
        return {k: _no_times(v) for k, v in value.items()
                if k not in ("saved_at", "path")}
    if isinstance(value, list):
        return [_no_times(v) for v in value]
    return value


def test_list_luts_copy(tmp_path):
    assert tpaths.list_luts(LUTS) == jpaths.list_luts(LUTS)
    assert len(tpaths.list_luts(LUTS)["luts"]) == 18
    assert all(item["example_name"] for item in tpaths.list_luts()["luts"])
    # an example matched by its punctuation-free key, and a missing folder
    (tmp_path / "examples").mkdir()
    (tmp_path / "My-Look.cube").write_text("LUT_3D_SIZE 2\n")
    (tmp_path / "examples" / "mylook.PNG").write_bytes(b"x")
    assert tpaths.list_luts(str(tmp_path)) == jpaths.list_luts(str(tmp_path))
    assert tpaths.list_luts(str(tmp_path))["luts"][0]["example_name"] \
        == "mylook.PNG"
    assert tpaths.list_luts(str(tmp_path / "none")) == jpaths.list_luts(
        str(tmp_path / "none"))
    assert tpaths._example_key("Teal & Orange_2") == jpaths._example_key(
        "Teal & Orange_2") == "tealorange2"


@pytest.mark.parametrize("name", ["Warm Look", "../../etc/passwd", "  ..  ",
                                  "a" * 120, "na/me?*", None, "x.y-z_1"])
def test_preset_names_copy(name):
    assert tpaths._sanitize_preset_name(name) == jpaths._sanitize_preset_name(
        name)


def test_presets_copy(tmp_path):
    ours, theirs = str(tmp_path / "t"), str(tmp_path / "j")
    for base, module in ((ours, tpaths), (theirs, jpaths)):
        assert module.presets_dir(base) == os.path.join(
            base, "VRGDG_AdjustPresets")
        assert module.preview_root(base) == os.path.join(
            base, "_tmp", "lut_previews")
        module.save_adjust_preset("Warm Look", {"temperature": 30,
                                                "contrast": 500}, base)
        module.save_adjust_preset("b/ad", module.AdjustSettings.normalize(
            {"fade": 12}), base)
        with open(os.path.join(module.presets_dir(base), "junk.json"),
                  "w") as handle:
            handle.write("{not json")
    assert _no_times(tpaths.list_adjust_presets(ours)) == _no_times(
        jpaths.list_adjust_presets(theirs))
    source = tmp_path / "import.json"
    source.write_text(json.dumps({"settings": {"exposure": 40}}))
    assert _no_times(tpaths.import_adjust_preset(str(source), ours)) \
        == _no_times(jpaths.import_adjust_preset(str(source), theirs))
    for name in ("Warm Look", "missing", "../t"):
        assert tpaths.delete_adjust_preset(name, ours) \
            == jpaths.delete_adjust_preset(name, theirs)
    assert [p["name"] for p in tpaths.list_adjust_presets(ours)] \
        == [p["name"] for p in jpaths.list_adjust_presets(theirs)] \
        == ["b_ad", "import"]
    with pytest.raises(FileNotFoundError):
        tpaths.import_adjust_preset(str(tmp_path / "none.json"), ours)
    assert os.path.abspath(tpaths.DEFAULT_OUTPUT_ROOT) == os.path.abspath(
        jpaths.DEFAULT_OUTPUT_ROOT)


# --------------------------------------------------------------------------
# the commands
# --------------------------------------------------------------------------

def _jax_cli(argv, capsys):
    from vrgdg_tpu import cli as jcli

    jcli.main(argv)
    return json.loads(capsys.readouterr().out)


def _port_cli(argv, capsys):
    cli.main(argv)
    return json.loads(capsys.readouterr().out)


@pytest.mark.parametrize("command", [
    ["lut", "{image}", "teal_orange.cube"],
    ["lut", "{image}", "teal_orange.cube", "--strength", "6"],
    ["adjust", "{image}", "--settings", json.dumps(ADJUST)],
    ["compare", "{image}", "{other}", "--mode", "slider",
     "--slider-position", "0.25"]])
def test_cli_image_commands_match_jax(image, tmp_path, capsys, command):
    other = str(tmp_path / "other.png")
    Image.fromarray(_noise(15, (90, 160, 3))).save(other)
    argv = [a.replace("{image}", image).replace("{other}", other)
            for a in command]
    want = _jax_cli(argv + ["-o", str(tmp_path / "j.png")], capsys)
    got = _port_cli(argv + ["-o", str(tmp_path / "t.png"), "--device",
                            "cpu"], capsys)
    assert got["device"] == "cpu"
    if command == ["lut", "{image}", "teal_orange.cube"]:
        # the command as a user types it decodes equal to the JAX CLI's
        np.testing.assert_array_equal(_pil(got["output"]),
                                      _pil(want["output"]))
    _within_one_level(got["output"], want["output"])


def test_cli_luts_and_make_lut_match_jax(tmp_path, capsys):
    assert _port_cli(["luts"], capsys) == _jax_cli(["luts"], capsys)
    want = _jax_cli(["make-lut", "#0b1d51, teal, #f3d27a", "-o",
                     str(tmp_path / "j" / "look.cube"), "--size", "9"], capsys)
    got = _port_cli(["make-lut", "#0b1d51, teal, #f3d27a", "-o",
                     str(tmp_path / "t" / "look.cube"), "--size", "9"],
                    capsys)
    assert {k: v for k, v in got.items() if k != "output"} == \
        {k: v for k, v in want.items() if k != "output"}
    with open(got["output"]) as a, open(want["output"]) as b:
        assert a.read() == b.read()


def test_cli_refuses_cuda_without_a_card(image, capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    for argv in (["lut", image, "teal_orange.cube"],
                 ["adjust", image, "--device", "cuda"],
                 ["compare", image, image]):
        with pytest.raises(SystemExit) as refused:
            cli.main(argv)
        assert refused.value.code == 2
        assert "no CUDA device is available" in capsys.readouterr().err


# --------------------------------------------------------------------------
# the port and chip_smoke.py import neither JAX, the JAX package nor Pillow
# --------------------------------------------------------------------------

_FORBIDDEN = re.compile(
    r"^\s*(?:import|from)\s+(jax|vrgdg_tpu|PIL)(?:\.|\s|$)", re.MULTILINE)


def test_port_sources_import_neither_jax_vrgdg_tpu_nor_pillow():
    files = glob.glob(os.path.join(REPO, "vrgdg_tpu_torch", "**", "*.py"),
                      recursive=True) + [os.path.join(REPO, "chip_smoke.py")]
    assert len(files) > 30
    for module in ("server/__init__.py", "server/routes.py",
                   "release_notes.py", "runtime/audio.py",
                   "runtime/audio_toolkit.py", "runtime/beats.py"):
        assert os.path.join(REPO, "vrgdg_tpu_torch", module) in files, module
    found = {}
    for path in files:
        with open(path, encoding="utf-8") as handle:
            hits = _FORBIDDEN.findall(handle.read())
        if hits:
            found[os.path.relpath(path, REPO)] = hits
    assert not found, found

