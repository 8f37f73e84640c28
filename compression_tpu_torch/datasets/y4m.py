"""Y4M (YUV4MPEG2) video reader (PyTorch port's copy of
compression_tpu/datasets/y4m.py).

Pure-Python counterpart of the reference's Y4M dataset op
(cc/kernels/y4m_dataset_kernels.cc:47-426): parses C420jpeg/C420/C444
headers and yields (Y [H, W, 1], CbCr [Hc, Wc, 2]) uint8 frame tuples,
concatenating frames across files.  Semantics are kept identical:
progressive only, 4:2:0 requires even dimensions, chroma planes interleave
into the last axis.
"""

from __future__ import annotations

from typing import Iterable, Iterator, Tuple

import numpy as np

__all__ = ["y4m_frames", "Y4MDataset"]

_DIGITS = set(b"0123456789")


def _parse_header(header: bytes, filename: str):
    if not header.startswith(b"YUV4MPEG2"):
        raise ValueError(
            f"Input file '{filename}' does not have a YUV4MPEG2 marker.")
    rest = header[len(b"YUV4MPEG2"):]
    width = height = 0
    chroma = None
    while rest:
        if len(rest) < 2 or rest[0:1] != b" ":
            raise ValueError(
                f"Input file '{filename}' has an invalid Y4M header. "
                f"Remaining header: {rest!r}.")
        key = rest[1:2]
        rest = rest[2:]
        if key == b"W" or key == b"H":
            i = 0
            while i < len(rest) and rest[i] in _DIGITS:
                i += 1
            value = int(rest[:i] or b"0")
            if value <= 0:
                raise ValueError(
                    f"Input file '{filename}' has an invalid "
                    f"{'width' if key == b'W' else 'height'} specifier.")
            if key == b"W":
                width = value
            else:
                height = value
            rest = rest[i:]
        elif key == b"C":
            for prefix, fmt in ((b"420jpeg", "420"), (b"420", "420"),
                                (b"444", "444")):
                if rest.startswith(prefix):
                    chroma = fmt
                    rest = rest[len(prefix):]
                    break
            else:
                raise ValueError(
                    f"Input file '{filename}' has an unsupported chroma "
                    f"format.")
        elif key == b"I":
            if not rest.startswith(b"p"):
                raise ValueError(
                    f"Input file '{filename}' is not in progressive format.")
            rest = rest[1:]
        else:
            i = rest.find(b" ")
            rest = rest[i:] if i >= 0 else b""
    if not width:
        raise ValueError(f"Input file '{filename}' has no width specifier.")
    if not height:
        raise ValueError(f"Input file '{filename}' has no height specifier.")
    if chroma is None:
        raise ValueError(
            f"Input file '{filename}' has no chroma format specifier.")
    if chroma == "420" and (width % 2 or height % 2):
        raise ValueError(
            f"Input file '{filename}' has 4:2:0 chroma format, but odd "
            f"width or height.")
    return width, height, chroma


def y4m_frames(filenames: Iterable[str]) -> Iterator[
        Tuple[np.ndarray, np.ndarray]]:
    """Yields (y [H, W, 1], cbcr [Hc, Wc, 2]) uint8 frames from .y4m files."""
    if isinstance(filenames, (str, bytes)):
        filenames = [filenames]
    for filename in filenames:
        with open(filename, "rb") as f:
            header = bytearray()
            while True:
                c = f.read(1)
                if not c:
                    raise ValueError(
                        f"Input file '{filename}' has an incomplete header.")
                if c == b"\n":
                    break
                header += c
                if len(header) > 1024:
                    raise ValueError(
                        f"Input file '{filename}' header too long.")
            width, height, chroma = _parse_header(bytes(header), filename)
            if chroma == "420":
                cw, ch = width // 2, height // 2
            else:
                cw, ch = width, height
            y_size = width * height
            c_size = cw * ch
            frame_size = y_size + 2 * c_size
            marker = b"FRAME"
            while True:
                line = f.readline()
                if not line:
                    break  # end of file
                if not line.startswith(marker):
                    raise ValueError(
                        f"Input file '{filename}' has an invalid FRAME "
                        f"marker.")
                data = f.read(frame_size)
                if len(data) != frame_size:
                    break  # incomplete trailing frame
                buf = np.frombuffer(data, np.uint8)
                y = buf[:y_size].reshape(height, width, 1)
                cb = buf[y_size : y_size + c_size].reshape(ch, cw)
                cr = buf[y_size + c_size :].reshape(ch, cw)
                cbcr = np.stack([cb, cr], axis=-1)
                yield y, cbcr


class Y4MDataset:
    """Iterable dataset over Y4M frames (reference python wrapper analog)."""

    def __init__(self, filenames):
        self.filenames = (
            [filenames] if isinstance(filenames, (str, bytes))
            else list(filenames))

    def __iter__(self):
        return y4m_frames(self.filenames)
