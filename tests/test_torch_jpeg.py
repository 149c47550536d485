"""The port's JPEG decoder (``detr_tensorflow_tpu_torch/data/jpeg.py``, the
C++ of ``data/jpeg.cpp``) against ``imageio.v2.imread``, the reading the JAX
package's loaders make, on the CPU.

Bit-equal is the bar: on the committed fixtures (``tests/data/jpeg``, written
by ``scripts/make_jpeg_fixtures.py``, whose ``expected.json`` holds imageio's
hashes for the card's machine, which has no imageio) and on files written
here from seeded numpy pictures at quality 10, 75 and 95 in every sampling
factor pair (Pillow's 4:4:4, 4:2:2 and 4:2:0, OpenCV's 4:4:0 and 4:1:1, and
gray), each sequential, progressive and with restart intervals. Out-of-scope
files raise with their reason. The JAX package's panoptic loader reads with
``cv2.imread``, not imageio: on the fixtures the two agree to the bit
(``CV2_IMAGEIO_LEVELS``), so the port's panoptic parity holds at that bound,
except that cv2 applies an EXIF orientation tag, which imageio (and the port)
leave unapplied.
"""

import hashlib
import importlib.util
import io
import json
import struct
import sys
import threading
from pathlib import Path

import cv2
import imageio.v2 as imageio
import numpy as np
import pytest

from detr_tensorflow_tpu_torch.data import image_io, jpeg
from torch_ranks import one_torch_thread  # noqa: F401  (autouse)

FIXTURES = Path(__file__).parent / "data" / "jpeg"
EXPECTED = json.loads((FIXTURES / "expected.json").read_text())
# The largest difference between cv2.imread (RGB) and imageio on the
# fixtures, measured: none.
CV2_IMAGEIO_LEVELS = 0

_spec = importlib.util.spec_from_file_location(
    "make_jpeg_fixtures", Path(__file__).parents[1] / "scripts" / "make_jpeg_fixtures.py")
fixtures = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(fixtures)


def _sha(a: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_expected_hashes_are_imageios(name):
    """``expected.json`` holds imageio's shape and hash of every fixture (the
    record the card's machine checks the decoder against)."""
    image = imageio.imread(FIXTURES / name)
    assert list(image.shape) == EXPECTED[name]["shape"] and image.dtype == np.uint8
    assert _sha(image) == EXPECTED[name]["sha256"]


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_decoder_equals_imageio_on_fixtures(name):
    """Every fixture decodes bit-equal to imageio, shape and dtype included."""
    got = jpeg.read_jpeg(str(FIXTURES / name))
    want = imageio.imread(FIXTURES / name)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    assert _sha(got) == EXPECTED[name]["sha256"]


def test_exif_orientation_is_not_applied():
    """imageio's Pillow reader leaves EXIF orientation unapplied (the
    fixture is tagged 6, rotate to display); so does the decoder."""
    name = "exif_orientation6_160x120.jpg"
    assert jpeg.read_jpeg(str(FIXTURES / name)).shape == (120, 160, 3)
    assert imageio.imread(FIXTURES / name).shape == (120, 160, 3)


def _encodings(sampling, quality, h, w, seed):
    """(label, bytes) of one picture in four codings: sequential,
    progressive, a restart interval of 2 MCUs, and progressive with an
    interval of 3 (Pillow's with optimised Huffman tables). OpenCV writes
    4:4:0 and 4:1:1, which Pillow cannot; Pillow the rest."""
    img = fixtures.picture(h, w, seed, gray=sampling == "gray")
    if sampling in ("440", "411"):
        factor = {"440": 0x121111, "411": 0x411111}[sampling]
        codings = {"sequential": {}, "progressive": dict(IMWRITE_JPEG_PROGRESSIVE=1),
                   "restart 2": dict(IMWRITE_JPEG_RST_INTERVAL=2),
                   "progressive restart 3": dict(IMWRITE_JPEG_PROGRESSIVE=1,
                                                 IMWRITE_JPEG_RST_INTERVAL=3)}
        return [(label, fixtures.opencv(img, IMWRITE_JPEG_QUALITY=quality,
                                        IMWRITE_JPEG_SAMPLING_FACTOR=factor, **kw))
                for label, kw in codings.items()]
    sub = {} if sampling == "gray" else {"subsampling": {"444": 0, "422": 1, "420": 2}[sampling]}
    codings = {"sequential": {}, "progressive": dict(progressive=True),
               "restart 2": dict(restart_marker_blocks=2),
               "progressive restart 3 optimised": dict(progressive=True, restart_marker_blocks=3,
                                                        optimize=True)}
    return [(label, fixtures.pillow(img, quality=quality, **sub, **kw))
            for label, kw in codings.items()]


@pytest.mark.parametrize("quality", [10, 75, 95])
@pytest.mark.parametrize("sampling", ["444", "422", "420", "440", "411", "gray"])
def test_decoder_equals_imageio_on_written_files(sampling, quality):
    """Files written here, bit-equal to imageio: odd and even sizes (the
    partial MCUs and the upsamplers' edge columns and rows), each coding."""
    for h, w in ((37, 53), (64, 48), (2, 3)):
        for label, data in _encodings(sampling, quality, h, w, seed=h * w + quality):
            got, want = jpeg.decode_jpeg(data), imageio.imread(io.BytesIO(data))
            assert got.shape == want.shape, (h, w, label)
            np.testing.assert_array_equal(got, want, err_msg=f"{h}x{w} {label}")


def _patched(data: bytes, find: bytes, offset: int, value: bytes) -> bytes:
    i = data.index(find) + offset
    return data[:i] + value + data[i + len(value):]


def _bad_dc_table(data: bytes, overflow: bool) -> bytes:
    """The first DC Huffman table made invalid, its length kept: three codes
    of length 1 (they overflow it, and a lookahead table filled before the
    check would be written past its end), or a first symbol of 16."""
    i = data.index(b"\xff\xc4") + 4
    assert data[i] >> 4 == 0, "the first DHT table is a DC one"
    counts = bytearray(data[i + 1:i + 17])
    if overflow:
        n = sum(counts)
        counts = bytearray([3] + [0] * 14 + [n - 3])
        return data[:i + 1] + bytes(counts) + data[i + 17:]
    return data[:i + 17] + b"\x10" + data[i + 18:]


def _refused():
    base = fixtures.pillow(fixtures.picture(24, 32, 1), quality=75)
    sof = base.index(b"\xff\xc0")
    scan_end = base.rindex(b"\xff\xd9")
    cmyk = io.BytesIO()
    from PIL import Image
    Image.fromarray(fixtures.picture(24, 32, 2)).convert("CMYK").save(cmyk, "JPEG")
    return {
        "arithmetic": (_patched(base, b"\xff\xc0", 1, b"\xc9"), "arithmetic coding \\(SOF9\\)"),
        "lossless": (_patched(base, b"\xff\xc0", 1, b"\xc3"), "lossless JPEG \\(SOF3\\)"),
        "12-bit": (_patched(base, b"\xff\xc0", 4, b"\x0c"), "12-bit samples"),
        "cmyk": (cmyk.getvalue(), "4 components \\(CMYK/YCCK\\)"),
        "truncated in a scan": (base[:(sof + scan_end) // 2 + 200], "truncated"),
        "no EOI": (base[:scan_end], "truncated"),
        "not a JPEG": (b"\x89PNG\r\n\x1a\n" + base, "not a JPEG"),
        "Huffman codes overflow": (_bad_dc_table(base, True), "a code of all ones"),
        "DC symbol above 15": (_bad_dc_table(base, False), "a DC symbol above 15"),
    }


@pytest.mark.parametrize("case", ["arithmetic", "lossless", "12-bit", "cmyk",
                                  "truncated in a scan", "no EOI", "not a JPEG",
                                  "Huffman codes overflow", "DC symbol above 15"])
def test_decoder_refuses_what_it_does_not_decode(case):
    """Arithmetic coding, lossless frames, 12-bit samples, four components, a
    file cut short (which libjpeg would pad and imageio refuses) and a
    Huffman table libjpeg rejects raise a ValueError naming the reason;
    nothing is returned."""
    data, reason = _refused()[case]
    with pytest.raises(ValueError, match=reason):
        jpeg.decode_jpeg(data)
    if case == "cmyk":  # imageio returns four channels the loaders would cut to three
        assert imageio.imread(io.BytesIO(data)).shape[-1] == 4
    if case.startswith("truncated") or case.startswith(("Huffman", "DC symbol")):
        with pytest.raises(OSError):
            imageio.imread(io.BytesIO(data))


def test_cv2_and_imageio_agree_on_the_fixtures():
    """The JAX panoptic loader's ``cv2.imread`` (BGR, turned RGB) against
    imageio on every colour fixture: the bound the port's panoptic parity
    uses (``CV2_IMAGEIO_LEVELS``). The one difference is the EXIF-tagged
    fixture, which cv2 turns upright (orientation 6: 90 degrees clockwise)
    and imageio leaves as stored; without the turn the two are equal."""
    worst = 0
    for name in sorted(EXPECTED):
        want = imageio.imread(FIXTURES / name)
        if want.ndim == 2:
            continue
        got = cv2.cvtColor(cv2.imread(str(FIXTURES / name), cv2.IMREAD_COLOR), cv2.COLOR_BGR2RGB)
        if name.startswith("exif_orientation6"):
            np.testing.assert_array_equal(got, np.rot90(want, k=-1))
            got = cv2.cvtColor(cv2.imread(str(FIXTURES / name),
                                          cv2.IMREAD_COLOR | cv2.IMREAD_IGNORE_ORIENTATION),
                               cv2.COLOR_BGR2RGB)
        worst = max(worst, int(np.abs(got.astype(int) - want.astype(int)).max()))
    assert worst == CV2_IMAGEIO_LEVELS


def test_imread_sends_jpeg_to_the_decoder(tmp_path, monkeypatch):
    """``image_io.imread`` decodes JPEG by content first (a JPEG named .png)
    and then by extension, with imageio, Pillow and OpenCV unimportable; a
    PNG named .jpg is refused, not handed elsewhere."""
    data = (FIXTURES / "q75_420_333x251.jpg").read_bytes()
    want = imageio.imread(io.BytesIO(data))
    names = ["a.jpg", "b.JPEG", "c.jpe", "d.jfif", "disguised.png", "no_extension"]
    for name in names:
        (tmp_path / name).write_bytes(data)
    png = tmp_path / "png.jpg"
    image_io.write_png(str(png), want)
    for mod in ("imageio", "imageio.v2", "PIL", "PIL.Image", "cv2"):
        monkeypatch.setitem(sys.modules, mod, None)
    for name in names:
        np.testing.assert_array_equal(image_io.imread(str(tmp_path / name)), want)
    with pytest.raises(ValueError, match="not a JPEG"):
        image_io.imread(str(png))


def test_decoding_in_threads_is_equal():
    """Eight threads decoding the fixtures at once (the loader's workers, the
    GIL released in the call) each get imageio's arrays."""
    names = sorted(EXPECTED)
    data = {n: (FIXTURES / n).read_bytes() for n in names}
    results, errors = {}, []

    def work(t):
        try:
            for n in names[t::2] + names:
                results[(t, n)] = _sha(jpeg.decode_jpeg(data[n]))
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)

    threads = [threading.Thread(target=work, args=(t,)) for t in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads) and not errors
    assert all(results[(t, n)] == EXPECTED[n]["sha256"] for t, n in results)


def test_fixture_frames_are_what_they_are_named():
    """The fixtures hold the codings they are named for (sampling factors,
    progressive frames, restart intervals, an EXIF block), read from their
    markers: the decoder's tests on them exercise those paths."""
    def frame(data):
        pos, out = 2, {"dri": 0, "exif": False}
        while data[pos + 1] != 0xDA:
            m, length = data[pos + 1], struct.unpack(">H", data[pos + 2:pos + 4])[0]
            body = data[pos + 4:pos + 2 + length]
            if m in (0xC0, 0xC2):
                out["sof"] = m
                out["factors"] = [(body[7 + 3 * i] >> 4, body[7 + 3 * i] & 15)
                                  for i in range(body[5])]
            out["dri"] = struct.unpack(">H", body)[0] if m == 0xDD else out["dri"]
            out["exif"] |= m == 0xE1 and body[:4] == b"Exif"
            pos += 2 + length
        return out

    want = {"cv2_q80_440_321x239.jpg": (0xC0, (1, 2), 0), "cv2_q80_411_321x239.jpg": (0xC0, (4, 1), 0),
            "q60_422_333x251.jpg": (0xC0, (2, 1), 0), "q90_444_333x251.jpg": (0xC0, (1, 1), 0),
            "q75_420_640x480.jpg": (0xC0, (2, 2), 0),
            "progressive_q80_420_400x300.jpg": (0xC2, (2, 2), 0),
            "restart_q75_420_257x183.jpg": (0xC0, (2, 2), 5),
            "restart_progressive_q75_201x157.jpg": (0xC2, (2, 2), 3)}
    for name, (sof, luma, dri) in want.items():
        f = frame((FIXTURES / name).read_bytes())
        assert (f["sof"], f["factors"][0], f["dri"]) == (sof, luma, dri), name
        assert f["factors"][1:] == [(1, 1), (1, 1)], name
    assert len(frame((FIXTURES / "gray_q75_300x200.jpg").read_bytes())["factors"]) == 1
    assert frame((FIXTURES / "exif_orientation6_160x120.jpg").read_bytes())["exif"]
