"""Time the port's PNG decoder (``acn_tpu_torch.data.png``) on a photo-like
image at a dataset's image size, once for each way its rows can be filtered.

    python -m acn_tpu_torch.scripts.bench_png
    python -m acn_tpu_torch.scripts.bench_png --hw 270 480 --repeats 5

The image is a smooth random field with pixel noise, drawn from ``--seed``.
It is encoded with each of the five row filters on every row, with the five
in turn (row r with filter r mod 5, as ``toy.write_dataset_dir`` writes),
and, where PIL is installed, by PIL itself (its own choice per row). Each
file is decoded ``--repeats`` times and checked against the image. Prints
one JSON line: per encoding, the row filters it holds, the file's bytes and
the median seconds of ``decode_png``; for PIL's file, also PIL's own decode.
Host code only: no card is used.
"""

from __future__ import annotations

import argparse
import io
import json
import statistics
import time
import zlib

import numpy as np

from acn_tpu_torch.data import png

FILTERS = {"none": 0, "sub": 1, "up": 2, "average": 3, "paeth": 4}


def photo_like(h: int, w: int, seed: int) -> np.ndarray:
    """uint8 (h, w, 3): a random field upsampled 16× (bilinear), plus noise."""
    rng = np.random.default_rng(seed)
    coarse = rng.random((h // 16 + 2, w // 16 + 2, 3)) * 255
    y, x = np.arange(h) / 16, np.arange(w) / 16
    y0, x0 = y.astype(int), x.astype(int)
    fy, fx = (y - y0)[:, None, None], (x - x0)[None, :, None]
    field = ((1 - fy) * ((1 - fx) * coarse[y0][:, x0] + fx * coarse[y0][:, x0 + 1])
             + fy * ((1 - fx) * coarse[y0 + 1][:, x0] + fx * coarse[y0 + 1][:, x0 + 1]))
    return np.clip(field + rng.normal(0, 6, field.shape), 0, 255).astype(np.uint8)


def row_filters(data: bytes, h: int) -> list:
    """The sorted distinct filter types of a PNG's rows."""
    idat, pos = b"", 8
    while pos < len(data):
        n = int.from_bytes(data[pos:pos + 4], "big")
        if data[pos + 4:pos + 8] == b"IDAT":
            idat += data[pos + 8:pos + 8 + n]
        pos += 12 + n
    raw = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, -1)
    return sorted(int(t) for t in np.unique(raw[:, 0]))


def median_s(fn, repeats: int) -> float:
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--hw", type=int, nargs=2, default=(1080, 1920), metavar=("H", "W"))
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    h, w = args.hw
    img = photo_like(h, w, args.seed)
    files = {name: png.encode_png(img, f) for name, f in FILTERS.items()}
    files["mixed"] = png.encode_png(img, np.arange(h) % 5)
    try:
        from PIL import Image
    except ImportError:
        Image = None
    if Image is not None:
        buf = io.BytesIO()
        Image.fromarray(img).save(buf, format="PNG")
        files["pil"] = buf.getvalue()
    out = {"hw": [h, w], "repeats": args.repeats, "encodings": {}}
    for name, data in files.items():
        if not np.array_equal(png.decode_png(data), img):
            raise AssertionError(f"decode_png gave other pixels for the {name} encoding")
        rec = {"filters": row_filters(data, h), "bytes": len(data),
               "decode_s": median_s(lambda: png.decode_png(data), args.repeats)}
        if name == "pil":
            rec["pil_decode_s"] = median_s(
                lambda: np.asarray(Image.open(io.BytesIO(data)).convert("RGB")), args.repeats)
        out["encodings"][name] = rec
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
