"""Raw planar frame I/O (headerless; geometry supplied by the caller).

The escape hatch for formats y4m cannot carry (float planes, alpha) and for
interop with `ffmpeg -f rawvideo` pipelines.
"""

from __future__ import annotations

from typing import BinaryIO, Union

import numpy as np
import torch

from sangnom_tpu_torch.core.clip import Clip
from sangnom_tpu_torch.core.formats import VideoFormat, get_format
from sangnom_tpu_torch.io.common import _open, read_frames_chunked


def _stream_dtype(fmt: VideoFormat) -> np.dtype:
    """The on-disk sample dtype: little-endian for >8-bit formats."""
    dt = fmt.np_dtype
    return dt.newbyteorder("<") if fmt.component_size > 1 else dt


def frame_size_bytes(fmt: VideoFormat, width: int, height: int) -> int:
    return sum(
        pw * ph * fmt.component_size
        for pw, ph in (fmt.plane_dims(width, height, i) for i in range(fmt.num_planes))
    )


def read_raw(
    f: Union[str, BinaryIO],
    format: VideoFormat | str,
    width: int,
    height: int,
    max_frames: int | None = None,
    device: torch.device | str = "cuda",
    **clip_kw,
) -> Clip:
    """Read back-to-back planar frames until EOF (or max_frames) into a clip
    on ``device``.  Frames stream directly into preallocated per-plane
    arrays (one copy), then go to the device in one copy a plane."""
    fmt = get_format(format) if isinstance(format, str) else format
    geom = [fmt.plane_dims(width, height, i) for i in range(fmt.num_planes)]

    fh, close = _open(f, "rb")
    try:
        planes = read_frames_chunked(
            fh, geom, _stream_dtype(fmt), max_frames,
            truncated_msg="truncated raw frame",
        )
        if not planes:
            raise ValueError("raw stream contains no complete frames")
        return Clip.from_numpy(planes, fmt, device=device, **clip_kw)
    finally:
        if close:
            fh.close()


def write_raw(f: Union[str, BinaryIO], clip: Clip) -> None:
    """Write back-to-back planar frames (little-endian for >8-bit).

    One device-to-host copy and convert per plane for the whole clip,
    zero-copy per-frame writes."""
    fh, close = _open(f, "wb")
    dt = _stream_dtype(clip.format)
    try:
        arrs = [
            np.ascontiguousarray(p.cpu().numpy()).astype(dt, copy=False)
            for p in clip.planes
        ]
        for n in range(clip.num_frames):
            for p in arrs:
                fh.write(p[n].data)
    finally:
        if close:
            fh.close()
