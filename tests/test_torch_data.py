"""The port's host data plane (``detr_tensorflow_tpu_torch/data``) against
the JAX package's and OpenCV, on the CPU: PNG decoding against imageio,
OpenCV's resamplings rebuilt without OpenCV, the augmentation under one
seed, normalization and eval examples. The COCO index, the synthetic set,
``HostDataset``, the multi-scale plan and the loaders are held in
``tests/test_torch_data_loaders.py``. Images are small (at most 128 px);
every comparison states its tolerance.
"""


import cv2
import imageio.v2 as imageio
import numpy as np
import pytest

from detr_tensorflow_tpu.data import coco as jax_coco
from detr_tensorflow_tpu.data import native as jax_native
from detr_tensorflow_tpu.data import processing as jax_processing
from detr_tensorflow_tpu.data import transforms as jax_transforms
from detr_tensorflow_tpu.train import TrainingConfig as JaxConfig
from detr_tensorflow_tpu_torch.data import image_io, native, processing, transforms
from detr_tensorflow_tpu_torch.train import TrainingConfig
from torch_ranks import one_torch_thread  # noqa: F401  (autouse)

CV2_MODES = {transforms.NEAREST: cv2.INTER_NEAREST, transforms.LINEAR: cv2.INTER_LINEAR,
             transforms.CUBIC: cv2.INTER_CUBIC, transforms.AREA: cv2.INTER_AREA}
# The measured bound of each rebuilt uint8 resampling against OpenCV's, in
# levels, and the largest share of pixels allowed off: nearest, linear and
# area bit-equal; cubic sums in float32 where OpenCV rounds 11-bit weights
# (measured: at most 0.03% of the pixels one level off).
LEVELS = {transforms.NEAREST: 0, transforms.LINEAR: 0, transforms.CUBIC: 1, transforms.AREA: 0}
SHARE = {transforms.NEAREST: 0.0, transforms.LINEAR: 0.0, transforms.CUBIC: 0.001,
         transforms.AREA: 0.0}
# One uint8 level after the torch_resnet normalization (the smallest std).
NORMALIZED_LEVEL = 1.0 / (255.0 * float(processing.IMAGENET_STD.min())) + 1e-6


def _smooth_and_noise(seed, h, w):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    smooth = np.clip(128 + 100 * np.sin(yy[..., None] / 7.0 + xx[..., None] / 11.0
                                        + np.arange(3)), 0, 255).astype(np.uint8)
    return [rng.integers(0, 256, (h, w, 3)).astype(np.uint8), smooth]


# --------------------------------------------------------------------- files


def _png(path, rows, width, channels, depth, color, filters):
    """A PNG whose rows are filtered with the given filter types (an
    encoder independent of the one under test)."""
    import struct
    import zlib

    bpp = channels * depth // 8
    out, prev = bytearray(), bytes(len(rows[0]))
    for row, kind in zip(rows, filters):
        row = bytes(row)
        enc = bytearray([kind])
        for i, x in enumerate(row):
            a = row[i - bpp] if i >= bpp else 0
            b, c = prev[i], prev[i - bpp] if i >= bpp else 0
            p = a + b - c
            paeth = a if abs(p - a) <= abs(p - b) and abs(p - a) <= abs(p - c) else (
                b if abs(p - b) <= abs(p - c) else c)
            pred = [0, a, b, (a + b) // 2, paeth][kind]
            enc.append((x - pred) & 255)
        out += enc
        prev = row

    def chunk(kind, body):
        return struct.pack(">I", len(body)) + kind + body + struct.pack(
            ">I", zlib.crc32(kind + body) & 0xFFFFFFFF)

    with open(path, "wb") as f:
        f.write(image_io.PNG_SIGNATURE + chunk(b"IHDR", struct.pack(
            ">IIBBBBB", width, len(rows), depth, color, 0, 0, 0)) + chunk(
            b"IDAT", zlib.compress(bytes(out))) + chunk(b"IEND", b""))


@pytest.mark.parametrize("depth", [8, 16])
@pytest.mark.parametrize("channels", [1, 3, 4])
def test_png_reader_equals_imageio(tmp_path, depth, channels):
    """Files cv2 writes (noise and a smooth image, 8 and 16 bits, gray, BGR
    and BGRA) and files whose rows use all five filter types, in turn:
    ``image_io.read_png`` bit-equal to imageio's reading, dtype and shape
    included. ``write_png`` round-trips and imageio reads it alike."""
    dtype = np.uint8 if depth == 8 else np.uint16
    rng = np.random.default_rng(depth + channels)
    for k, img in enumerate(_smooth_and_noise(channels, 37, 53)):
        img = (img.astype(np.uint32) * (257 if depth == 16 else 1)).astype(dtype)
        if depth == 16:
            img = img + rng.integers(0, 200, img.shape).astype(dtype)
        img = img[..., :1] if channels == 1 else img
        img = np.concatenate([img, img[..., :1]], -1) if channels == 4 else img
        path = str(tmp_path / f"cv{k}.png")
        cv2.imwrite(path, img[..., 0] if channels == 1 else img)
        got, want = image_io.read_png(path), imageio.imread(path)
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
    color = {1: 0, 3: 2, 4: 6}[channels]
    rows = rng.integers(0, 256, (10, 23 * channels * depth // 8)).astype(np.uint8)
    rows[5:] = (np.arange(rows.shape[1]) * 3 % 256)[None]  # smooth rows too
    path = str(tmp_path / "filters.png")
    _png(path, rows, 23, channels, depth, color, [0, 1, 2, 3, 4, 4, 3, 2, 1, 0])
    got, want = image_io.read_png(path), imageio.imread(path)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    if depth == 8:
        img = rng.integers(0, 256, (11, 13, channels)).astype(np.uint8)
        img = img[..., 0] if channels == 1 else img
        image_io.write_png(str(tmp_path / "w.png"), img)
        np.testing.assert_array_equal(image_io.read_png(str(tmp_path / "w.png")), img)
        np.testing.assert_array_equal(imageio.imread(str(tmp_path / "w.png")), img)


def test_read_image_formats(tmp_path):
    """``read_image``: gray to three channels, alpha dropped, ``.npy`` as
    stored, JPEG through ``data/jpeg.py`` (equal to the JAX package's reading
    with imageio)."""
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (9, 7, 4)).astype(np.uint8)
    cv2.imwrite(str(tmp_path / "a.png"), img)
    np.testing.assert_array_equal(image_io.read_image(str(tmp_path / "a.png")),
                                  jax_coco._read_image(str(tmp_path / "a.png")))
    cv2.imwrite(str(tmp_path / "g.png"), img[..., 0])
    np.testing.assert_array_equal(image_io.read_image(str(tmp_path / "g.png")),
                                  jax_coco._read_image(str(tmp_path / "g.png")))
    cv2.imwrite(str(tmp_path / "j.jpg"), img[..., :3])
    np.testing.assert_array_equal(image_io.read_image(str(tmp_path / "j.jpg")),
                                  jax_coco._read_image(str(tmp_path / "j.jpg")))
    np.save(tmp_path / "n.npy", img[..., :3])
    np.testing.assert_array_equal(image_io.read_image(str(tmp_path / "n.npy")), img[..., :3])
    with pytest.raises(ValueError):
        image_io.read_png(str(tmp_path / "j.jpg"))


# ---------------------------------------------------------------- resampling


@pytest.mark.parametrize("mode", list(CV2_MODES))
def test_resize_matches_cv2(mode):
    """``transforms.resize`` against ``cv2.resize`` on uint8 noise and a
    smooth image, enlarging, shrinking and mixed, and on float32: uint8
    within LEVELS[mode] levels on at most SHARE[mode] of the pixels
    (bit-equal but for cubic), float32 within 2e-5."""
    worst, share = 0, 0.0
    for img in _smooth_and_noise(1, 53, 71):
        for oh, ow in [(32, 40), (96, 128), (53, 100), (80, 35), (26, 35), (106, 142)]:
            want = cv2.resize(img, (ow, oh), interpolation=CV2_MODES[mode]).astype(int)
            got = transforms.resize(img, oh, ow, mode)
            assert got.dtype == np.uint8 and got.shape == want.shape
            diff = np.abs(got.astype(int) - want)
            worst, share = max(worst, int(diff.max())), max(share, float((diff > 0).mean()))
    print(f"{mode}: max {worst} levels on {share:.4f} of the pixels")
    assert worst <= LEVELS[mode] and share <= SHARE[mode]
    f = np.random.default_rng(2).normal(size=(40, 56, 3)).astype(np.float32)
    for oh, ow in [(30, 90), (20, 28), (64, 40)]:
        want = cv2.resize(f, (ow, oh), interpolation=CV2_MODES[mode])
        np.testing.assert_allclose(transforms.resize(f, oh, ow, mode), want, atol=2e-5)


def test_warp_scale_matches_cv2():
    """``transforms.warp_scale`` against ``cv2.warpAffine`` of a scale about
    the center (INTER_LINEAR, zero border): within one level on at most
    0.1% of the pixels (float32 source positions; measured <=0.06%)."""
    for img in _smooth_and_noise(4, 61, 83):
        h, w = img.shape[:2]
        for sx, sy in [(0.5, 1.5), (1.3, 0.7), (0.77, 0.91), (1.49, 1.01)]:
            cx, cy = w / 2.0, h / 2.0
            m = np.array([[sx, 0.0, cx * (1 - sx)], [0.0, sy, cy * (1 - sy)]])
            want = cv2.warpAffine(img, m, (w, h), flags=cv2.INTER_LINEAR).astype(int)
            diff = np.abs(transforms.warp_scale(img, sx, sy, cx, cy).astype(int) - want)
            assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3, (sx, sy)


def test_detr_transform_matches_jax_under_one_seed():
    """``detr_transform`` against the JAX transform from the same seed, 40
    seeds with augmentation and one without: both consume the Generator
    alike (its state equal after), boxes within 1e-6, classes equal, images
    within one level (the resampler's bound; bit-equal where the ops are)."""
    rng = np.random.default_rng(0)
    config = JaxConfig(image_size=(48, 80))
    off = 0
    for seed in range(41):
        img = rng.integers(0, 256, (70, 90, 3)).astype(np.uint8)
        n = int(rng.integers(1, 6))
        boxes = np.concatenate([rng.uniform(0.2, 0.8, (n, 2)), rng.uniform(0.05, 0.4, (n, 2))],
                               -1).astype(np.float32)
        classes = rng.integers(1, 9, n)
        aug = seed < 40
        r1, r2 = np.random.default_rng(seed), np.random.default_rng(seed)
        want = jax_transforms.detr_transform(img, boxes, classes, config, aug, rng=r1)
        got = transforms.detr_transform(img, boxes, classes, config, aug, rng=r2)
        assert r1.bit_generator.state == r2.bit_generator.state
        assert got[0].shape == want[0].shape and got[0].dtype == want[0].dtype
        off = max(off, int(np.abs(got[0].astype(int) - want[0].astype(int)).max()))
        np.testing.assert_allclose(got[1], want[1], atol=1e-6)
        np.testing.assert_array_equal(got[2], want[2])
    assert off <= 1


def test_normalizers_and_eval_example_equal_jax():
    """The native normalizers and ``make_eval_example`` bit-equal to the JAX
    package's (same C++ source and flags), and within 1e-6 of their plain
    numpy versions; ``normalized_images`` of a float image, ``tf_resnet``
    and ``denormalize_image`` equal as well."""
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (70, 90, 3)).astype(np.uint8)
    assert jax_native.get_lib() is not None
    np.testing.assert_array_equal(native.normalize_torch(img), jax_native.normalize_torch(img))
    np.testing.assert_array_equal(native.normalize_caffe(img), jax_native.normalize_caffe(img))
    np.testing.assert_array_equal(native.normalize_torch_into_bucket(img, 128, 128),
                                  jax_native.normalize_torch_into_bucket(img, 128, 128))
    for method in ("torch_resnet", "tf_resnet"):
        cfg = TrainingConfig(normalized_method=method)
        np.testing.assert_allclose(processing.normalized_images(img, cfg),
                                   processing.normalize_numpy(img, method), atol=1e-5)
        np.testing.assert_array_equal(processing.normalized_images(img, cfg),
                                      jax_processing.normalized_images(img, cfg))
        f = rng.normal(size=(5, 6, 3)).astype(np.float32)
        np.testing.assert_array_equal(processing.normalized_images(f, cfg),
                                      jax_processing.normalized_images(f, cfg))
        np.testing.assert_array_equal(processing.denormalize_image(f, cfg),
                                      jax_processing.denormalize_image(f, cfg))
    boxes = np.array([[0.5, 0.5, 0.2, 0.3]], np.float32)
    for method in ("torch_resnet", "tf_resnet"):
        cfg = TrainingConfig(normalized_method=method, num_queries=10)
        got = processing.make_eval_example(img, boxes, [3], cfg, 64)
        want = jax_processing.make_eval_example(img, boxes, [3], cfg, 64)
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
    for k, (g, w) in enumerate(zip(processing.pad_image_to_bucket(img[:, :, 0], 32),
                                   jax_processing.pad_image_to_bucket(img[:, :, 0], 32))):
        np.testing.assert_array_equal(g, w)
