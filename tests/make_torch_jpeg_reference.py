"""Write tests/fixtures/torch_jpeg_reference.npz: small JPEGs from libjpeg
encoders, with libjpeg's decoded pixels and the data plane's batch_transform
outputs on them.

``chip_smoke.py`` holds another decoder (nvJPEG on a machine without
libjpeg) against these outputs, and ``tests/test_torch_data.py`` checks
that libjpeg still gives them bit for bit. The images are drawn from a
numpy seed: smooth shading, saturated shapes with sharp edges and faint
noise, encoded as the JPEGs users train on are: the port's own libjpeg
encoder and cv2's (libjpeg-turbo) at 4:2:0, 4:2:2 and 4:4:4 chroma,
grayscale and progressive.

    python -m tests.make_torch_jpeg_reference
"""
import os

import cv2
import numpy as np

from virtex_tpu_torch import native

PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures",
                    "torch_jpeg_reference.npz")
SEED = 0
OUT_SIZE = 32
# name: (height, width, encoder, quality, cv2 flags)
IMAGES = {
    "libjpeg_q95_420": (75, 97, "libjpeg", 95, ()),
    "cv2_q85_420": (64, 90, "cv2", 85, ()),
    "cv2_q90_422": (70, 66, "cv2", 90, (cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                                        cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422)),
    "cv2_q95_444": (57, 80, "cv2", 95, (cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                                        cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444)),
    "cv2_q90_gray": (66, 77, "cv2_gray", 90, ()),
    "cv2_q90_progressive": (80, 64, "cv2", 90,
                            (cv2.IMWRITE_JPEG_PROGRESSIVE, 1)),
}


def scene(rng, h: int, w: int) -> np.ndarray:
    """RGB8: a shaded background, three saturated rectangles and discs, and
    noise of ±3."""
    y, x = np.mgrid[0:h, 0:w].astype(np.float32)
    img = (rng.uniform(60, 190, 3) + rng.uniform(-40, 40, 3) * (y / h)[..., None]
           + rng.uniform(-40, 40, 3) * (x / w)[..., None])
    for _ in range(3):
        colour = rng.choice([0.0, 255.0], 3) * rng.uniform(0.7, 1.0)
        cy, cx = rng.uniform(0, h), rng.uniform(0, w)
        r = rng.uniform(0.15, 0.35) * min(h, w)
        if rng.rand() < 0.5:
            inside = (np.abs(y - cy) < r) & (np.abs(x - cx) < 1.5 * r)
        else:
            inside = (y - cy) ** 2 + (x - cx) ** 2 < r * r
        img[inside] = colour
    img += rng.randint(-3, 4, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


def encode(plane, rgb, encoder: str, quality: int, flags) -> bytes:
    if encoder == "libjpeg":
        return plane.encode_jpeg(rgb, quality)
    params = [cv2.IMWRITE_JPEG_QUALITY, quality, *flags]
    src = (cv2.cvtColor(rgb, cv2.COLOR_RGB2GRAY) if encoder == "cv2_gray"
           else rgb[:, :, ::-1])
    ok, out = cv2.imencode(".jpg", src, params)
    assert ok
    return out.tobytes()


def transform_params(rng, dims):
    """The batch_transform arguments: a crop of each image (every third the
    whole image), alternate flips, and a colour jitter per image."""
    rects, jitters = [], []
    for i, (h, w) in enumerate(dims):
        if i % 3 == 2:
            rects.append((0, 0, -1, -1))
        else:
            ch, cw = rng.randint(h // 2, h + 1), rng.randint(w // 2, w + 1)
            rects.append((rng.randint(0, h - ch + 1), rng.randint(0, w - cw + 1),
                          ch, cw))
        jitters.append(native.jitter_params(
            rng.permutation(4), *rng.uniform(0.8, 1.2, 3),
            rng.uniform(-0.05, 0.05)))
    flips = np.arange(len(dims)) % 2
    return (np.asarray(rects, np.int32), flips.astype(np.int32),
            np.stack(jitters))


def outputs(plane, jpegs, rects, flips, jitters):
    """What the reference holds of a decoder: each image decoded, the batch
    as uint8 with jitter (the train pipeline's device-normalized path) and
    as ImageNet-normalized float32 without."""
    return ([plane.decode(j) for j in jpegs],
            plane.batch_transform(jpegs, rects, flips, OUT_SIZE,
                                  native.RAW_MEAN, native.RAW_STD, jitters,
                                  uint8=True),
            plane.batch_transform(jpegs, rects, flips, OUT_SIZE))


def main() -> None:
    rng = np.random.RandomState(SEED)
    plane = native.DataPlane("libjpeg")
    jpegs = [encode(plane, scene(rng, h, w), enc, q, flags)
             for h, w, enc, q, flags in IMAGES.values()]
    rects, flips, jitters = transform_params(
        rng, [(h, w) for h, w, *_ in IMAGES.values()])
    pixels, out_u8, out_f32 = outputs(plane, jpegs, rects, flips, jitters)
    arrays = {"names": np.asarray(list(IMAGES)), "rects": rects,
              "flips": flips, "jitters": jitters, "out_uint8": out_u8,
              "out_float32": out_f32}
    for i, (j, p) in enumerate(zip(jpegs, pixels)):
        arrays[f"jpeg_{i}"] = np.frombuffer(j, np.uint8)
        arrays[f"pixels_{i}"] = p
    np.savez_compressed(PATH, **arrays)
    print(f"wrote {PATH}: {os.path.getsize(PATH)} bytes")


if __name__ == "__main__":
    main()
