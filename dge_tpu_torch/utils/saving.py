"""Artifact saving: PNG images, videos, the run's command and config.

JAX counterpart: ``dge_tpu/utils/saving.py``, which goes through imageio.
Images here go through a small stdlib (zlib/struct) PNG codec, so rendering
needs no imaging package: the writer emits 8-bit RGB; the reader takes
8-bit non-interlaced greyscale, RGB and their alpha forms (all five row
filters), which covers the capture images. JPEG captures are decoded by
imageio or PIL, imported only when one is met. ``load_image(size=)`` resizes
by area averaging in numpy (the JAX version calls ``cv2.INTER_AREA``).
``save_video`` runs only when imageio is importable.
"""

from __future__ import annotations

import json
import os
import struct
import zlib
from typing import Callable, Optional, Sequence

import numpy as np

_PNG_SIG = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}  # PNG colour type -> samples per pixel


def _to_u8(img: np.ndarray) -> np.ndarray:
    img = np.asarray(img)
    if img.dtype != np.uint8:
        img = (np.clip(img, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
    return img


def _chunk(kind: bytes, payload: bytes) -> bytes:
    return (struct.pack(">I", len(payload)) + kind + payload
            + struct.pack(">I", zlib.crc32(kind + payload) & 0xFFFFFFFF))


def encode_png(img: np.ndarray) -> bytes:
    """[H, W, 3] uint8 (or float in [0, 1]) -> PNG bytes (8-bit RGB)."""
    img = _to_u8(img)
    if img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"expected [H, W, 3], got {img.shape}")
    h, w, _ = img.shape
    raw = np.zeros((h, 1 + 3 * w), np.uint8)  # filter byte 0 on every row
    raw[:, 1:] = img.reshape(h, 3 * w)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    return (_PNG_SIG + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
            + _chunk(b"IEND", b""))


def _unfilter_slow(kind: int, cur: bytearray, prev: bytes, bpp: int):
    """Average (3) and Paeth (4) row filters, byte by byte."""
    for i in range(len(cur)):
        a = cur[i - bpp] if i >= bpp else 0
        b = prev[i]
        if kind == 3:
            pred = (a + b) >> 1
        else:
            c = prev[i - bpp] if i >= bpp else 0
            p = a + b - c
            pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
            pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
        cur[i] = (cur[i] + pred) & 0xFF


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes -> [H, W, C] uint8 (8-bit, non-interlaced)."""
    if data[:8] != _PNG_SIG:
        raise ValueError("not a PNG file")
    pos, idat, hdr = 8, [], None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        payload = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if kind == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", payload)
        elif kind == b"IDAT":
            idat.append(payload)
        elif kind == b"IEND":
            break
    if hdr is None:
        raise ValueError("PNG without IHDR")
    w, h, depth, ctype, _, _, interlace = hdr
    if depth != 8 or ctype not in _CHANNELS or interlace != 0:
        raise ValueError(f"unsupported PNG: bit depth {depth}, colour type "
                         f"{ctype}, interlace {interlace}")
    bpp = _CHANNELS[ctype]
    stride = w * bpp
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    rows = raw.reshape(h, 1 + stride)
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(h):
        kind = int(rows[y, 0])
        cur = rows[y, 1:]
        if kind == 0:
            rec = cur.copy()
        elif kind == 1:  # Sub: running sum per channel, mod 256
            rec = np.cumsum(cur.reshape(w, bpp), axis=0,
                            dtype=np.uint8).reshape(-1)
        elif kind == 2:  # Up
            rec = cur + prev
        elif kind in (3, 4):
            buf = bytearray(cur.tobytes())
            _unfilter_slow(kind, buf, prev.tobytes(), bpp)
            rec = np.frombuffer(bytes(buf), np.uint8)
        else:
            raise ValueError(f"bad PNG row filter {kind}")
        out[y] = rec
        prev = out[y]
    return out.reshape(h, w, bpp)


def save_image(path: str, img: np.ndarray) -> str:
    """img: [H, W, 3] float [0,1] or uint8, written as an 8-bit RGB PNG."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(encode_png(img))
    return path


IMAGE_EXTS = (".png", ".jpg", ".JPG", ".jpeg")


def find_image(directory: str, stem: str) -> str:
    """The path of ``<stem>`` with the first image extension that exists in
    ``directory`` (``<stem>.png`` when none does, so that opening it names
    the missing file)."""
    for ext in IMAGE_EXTS:
        path = os.path.join(directory, stem + ext)
        if os.path.exists(path):
            return path
    return os.path.join(directory, stem + IMAGE_EXTS[0])


def _decode_other(path: str) -> np.ndarray:
    """A non-PNG image (JPEG) through imageio or PIL → uint8 array."""
    try:
        import imageio.v2 as imageio

        return np.asarray(imageio.imread(path))
    except ImportError:
        pass
    try:
        from PIL import Image
    except ImportError:
        raise RuntimeError(
            f"cannot decode {path}: only PNG is read without an imaging "
            "package; install imageio or Pillow, or convert the capture's "
            "images to PNG") from None
    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"))


def _area_weights(n_in: int, n_out: int) -> np.ndarray:
    """[n_out, n_in] row-stochastic weights: output cell i covers
    [i, i+1)·n_in/n_out of the input axis and weighs each input cell by the
    length of their overlap."""
    scale = n_in / n_out
    lo = np.arange(n_out)[:, None] * scale
    hi = lo + scale
    cell = np.arange(n_in)[None, :]
    overlap = np.clip(np.minimum(hi, cell + 1) - np.maximum(lo, cell), 0, None)
    return (overlap / scale).astype(np.float64)


def resize_area(img: np.ndarray, size) -> np.ndarray:
    """[H, W, C] float → [size[0], size[1], C] float32 by area averaging,
    separably: exact box means for integer down-scale factors, overlap
    weights otherwise (what ``cv2.INTER_AREA`` computes when shrinking;
    enlarging repeats pixels with blended seams)."""
    h, w = int(size[0]), int(size[1])
    out = np.einsum("ih,hwc->iwc", _area_weights(img.shape[0], h),
                    img.astype(np.float64))
    out = np.einsum("jw,iwc->ijc", _area_weights(img.shape[1], w), out)
    return out.astype(np.float32)


def load_image(path: str, size: Optional[tuple] = None) -> np.ndarray:
    """Returns [H, W, 3] float32 in [0, 1], area-resized to ``size`` =
    (height, width) when it is given and differs."""
    with open(path, "rb") as f:
        head = f.read(8)
        img = decode_png(head + f.read()) if head == _PNG_SIG else None
    if img is None:
        img = _decode_other(path)
    if img.ndim == 2:
        img = img[..., None]
    if img.shape[2] < 3:
        img = np.repeat(img[..., :1], 3, axis=-1)
    img = img[..., :3].astype(np.float32) / 255.0
    if size is not None and tuple(size) != img.shape[:2]:
        img = resize_area(img, size)
    return img


def save_image_grid(path: str, imgs: Sequence[np.ndarray],
                    cols: int = 4) -> str:
    """Tile images into a grid (SaverMixin save_image_grid analog)."""
    imgs = [_to_u8(i) for i in imgs]
    h, w = imgs[0].shape[:2]
    cols = min(cols, len(imgs))
    rows = -(-len(imgs) // cols)
    grid = np.zeros((rows * h, cols * w, 3), np.uint8)
    for i, im in enumerate(imgs):
        r, c = divmod(i, cols)
        grid[r * h:(r + 1) * h, c * w:(c + 1) * w] = im
    return save_image(path, grid)


def save_video(path: str, frames: Sequence[np.ndarray], fps: int = 30,
               log: Optional[Callable[[str], None]] = None) -> Optional[str]:
    """Image sequence -> mp4 (gif where imageio has no ffmpeg); skipped,
    with a log line, where imageio is not installed."""
    log = log or (lambda msg: None)
    try:
        import imageio.v2 as imageio
    except ImportError:
        log(f"imageio not installed: skipping video {path}")
        return None
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    frames = [_to_u8(f) for f in frames]
    try:
        imageio.mimsave(path, frames, fps=fps)
    except Exception:
        alt = os.path.splitext(path)[0] + ".gif"
        imageio.mimsave(alt, frames, duration=1.0 / fps)
        return alt
    return path


def save_json(path: str, obj) -> str:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(obj, f, indent=2, default=float)
    return path


def save_run_info(trial_dir: str, argv: Sequence[str], cfg: dict) -> None:
    """cmd.txt (the command line) and parsed.yaml (the parsed config,
    written as JSON, which YAML readers also read)."""
    with open(os.path.join(trial_dir, "cmd.txt"), "w") as f:
        f.write(" ".join(argv) + "\n")
    save_json(os.path.join(trial_dir, "parsed.yaml"), cfg)
