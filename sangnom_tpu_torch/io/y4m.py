"""YUV4MPEG2 (.y4m) reader / writer.

Supports the planar formats the filter accepts: C420/C422/C444 at 8 bits and
their p10/p12/p14/p16 extensions (little-endian uint16), C411, plus Cmono.
Interlacing flags map to Clip parity: 't' -> tff, 'b' -> bff.  Readers put
the planes on the caller's ``device`` ("cuda" unless asked otherwise, as
`Clip.from_numpy`); writers copy each plane to the host once.
"""

from __future__ import annotations

from typing import BinaryIO, Union

import numpy as np
import torch

from sangnom_tpu_torch.core.clip import Clip
from sangnom_tpu_torch.core.formats import get_format
from sangnom_tpu_torch.io.common import _open, read_frames_chunked
from sangnom_tpu_torch.utils.profiling import (
    DOWNLOAD, PARSE, SERIALIZE, UPLOAD, WRITE, count, span)

_COLORSPACE_TO_FORMAT = {
    "mono": "GRAY8",
    "420": "YUV420P8",
    "420jpeg": "YUV420P8",
    "420mpeg2": "YUV420P8",
    "420paldv": "YUV420P8",
    "422": "YUV422P8",
    "444": "YUV444P8",
    "411": "YUV411P8",  # y4m C411 (mjpegtools): 4:1:1, 8-bit only
}
for _tag, _sub in (("420", "420"), ("422", "422"), ("444", "444")):
    for _bits in (10, 12, 14, 16):
        _COLORSPACE_TO_FORMAT[f"{_tag}p{_bits}"] = f"YUV{_sub}P{_bits}"
for _bits in (10, 12, 14, 16):
    _COLORSPACE_TO_FORMAT[f"monop{_bits}"] = f"GRAY{_bits}"

_FORMAT_TO_COLORSPACE = {
    "GRAY8": "mono",
    "YUV420P8": "420",
    "YUV422P8": "422",
    "YUV444P8": "444",
    "YUV411P8": "411",
    "YV411": "411",
}
for _sub in ("420", "422", "444"):
    for _bits in (10, 12, 14, 16):
        _FORMAT_TO_COLORSPACE[f"YUV{_sub}P{_bits}"] = f"{_sub}p{_bits}"
for _bits in (10, 12, 14, 16):
    _FORMAT_TO_COLORSPACE[f"GRAY{_bits}"] = f"monop{_bits}"


def _sample_dtype(component_size: int) -> np.dtype:
    return np.dtype("<u2") if component_size == 2 else np.dtype("u1")


def _parse_header(fh) -> dict:
    header = fh.readline().decode("ascii", "replace").strip()
    if not header.startswith("YUV4MPEG2"):
        raise ValueError("not a YUV4MPEG2 stream")
    width = height = None
    cs = "420"
    interlace = "p"
    fps = (25, 1)
    aspect = "1:1"
    for tok in header.split()[1:]:
        key, val = tok[0], tok[1:]
        if key == "W":
            width = int(val)
        elif key == "H":
            height = int(val)
        elif key == "C":
            cs = val.lower()
        elif key == "I":
            interlace = val.lower()
        elif key == "F":
            num, den = val.split(":")
            fps = (int(num), int(den))
        elif key == "A":
            aspect = val
    if width is None or height is None:
        raise ValueError("y4m header missing W/H")
    if cs not in _COLORSPACE_TO_FORMAT:
        raise ValueError(f"unsupported y4m colorspace C{cs}")
    fmt = get_format(_COLORSPACE_TO_FORMAT[cs])
    dt = _sample_dtype(fmt.component_size)
    geom = [fmt.plane_dims(width, height, i) for i in range(fmt.num_planes)]
    return dict(
        fmt=fmt, dt=dt, geom=geom, interlace=interlace, fps=fps,
        aspect=aspect, colorspace=cs,
        frame_bytes=sum(pw * ph * dt.itemsize for pw, ph in geom),
    )


def _read_frame_block(fh, info, max_frames):
    """Read up to max_frames frames after the header into per-plane
    arrays ([n, ph, pw], stream dtype) through the single-copy readinto
    path (io.common.read_frames_chunked).  Returns [] at immediate EOF."""

    def frame_marker() -> bool:
        line = fh.readline()
        if not line:
            return False
        if not line.startswith(b"FRAME"):
            raise ValueError(f"expected FRAME marker, got {line[:20]!r}")
        return True

    return read_frames_chunked(
        fh, info["geom"], info["dt"], max_frames,
        prologue=frame_marker, truncated_msg="truncated y4m frame",
    )


def _read_window(fh, info, max_frames, device, window: int | None = None):
    """Parse up to ``max_frames`` frames and put them on ``device``: a Clip,
    or None at the stream's end.  Its spans carry ``window`` as their call
    id."""
    with span(PARSE, call=window) as sp:
        planes = _read_frame_block(fh, info, max_frames)
        if sp and planes:
            n = planes[0].shape[0]
            sp.set(frames=n, bytes=n * info["frame_bytes"])
            count("frames_in", n)
            count("bytes_read", n * info["frame_bytes"])
    if not planes:
        return None
    with span(UPLOAD, call=window) as sp:
        if sp:
            sp.set(bytes=sum(p.nbytes for p in planes))
            if torch.device(device).type != "cpu":
                count("h2d_copies", len(planes))
                count("h2d_bytes", sum(p.nbytes for p in planes))
        return _to_clip(planes, info, device)


def _to_clip(planes, info, device) -> Clip:
    # Clip.from_numpy converts the stream dtype ('<u2' for >8-bit) to the
    # storage dtype and makes one host-to-device copy a plane.
    return Clip.from_numpy(
        planes, info["fmt"], device=device, tff=(info["interlace"] != "b"),
        props={"y4m_interlace": info["interlace"], "y4m_fps": info["fps"],
               "y4m_aspect": info["aspect"],
               "y4m_colorspace": info["colorspace"]},
    )


def read_y4m(f: Union[str, BinaryIO], max_frames: int | None = None,
             device: torch.device | str = "cuda") -> Clip:
    """Parse a .y4m stream into a Clip on ``device``."""
    fh, close = _open(f, "rb")
    try:
        info = _parse_header(fh)
        clip = _read_window(fh, info, max_frames, device)
        if clip is None:
            raise ValueError("y4m stream contains no frames")
        return clip
    finally:
        if close:
            fh.close()


def iter_y4m(
    f: Union[str, BinaryIO], window: int, max_frames: int | None = None,
    device: torch.device | str = "cuda",
):
    """Stream a .y4m source as Clips on ``device`` of up to ``window``
    frames each — bounded memory for arbitrarily long streams.  The filter
    is per-frame independent (no temporal taps), so windowed processing is
    exact; only the bob pipeline needs one frame of lookahead across windows
    (handled by the CLI's --window mode).  The spans of window k carry k as
    their call id."""
    if window < 1:
        raise ValueError("window must be >= 1")
    total = 0
    fh, close = _open(f, "rb")
    try:
        info = _parse_header(fh)
        k = 0
        while max_frames is None or total < max_frames:
            take = (
                window if max_frames is None
                else min(window, max_frames - total)
            )
            clip = _read_window(fh, info, take, device, window=k)
            if clip is None:
                return
            got = clip.num_frames
            total += got
            k += 1
            yield clip
            if got < take:
                return
    finally:
        if close:
            fh.close()


def write_y4m(f: Union[str, BinaryIO], clip: Clip,
              fps: tuple[int, int] | None = None,
              interlace: str = "p", window: int | None = None) -> None:
    """Serialize a Clip as .y4m.  ``fps`` defaults to the framerate the clip
    was read with (``y4m_fps`` prop), else 25:1.  Raises for formats y4m
    cannot carry (float, alpha).  ``window``: the call id of its spans."""
    name = clip.format.name
    if name not in _FORMAT_TO_COLORSPACE:
        raise ValueError(f"format {name} has no y4m colorspace")
    # round-trip the exact chroma-siting tag the stream came with
    # (420jpeg/420mpeg2/420paldv all decode as YUV420P8; siting doesn't
    # affect this filter's math but the tag should survive)
    cs = clip.props.get("y4m_colorspace")
    if cs is None or _COLORSPACE_TO_FORMAT.get(cs) != name:
        cs = _FORMAT_TO_COLORSPACE[name]
    if fps is None:
        fps = clip.props.get("y4m_fps", (25, 1))
    aspect = clip.props.get("y4m_aspect", "1:1")
    fh, close = _open(f, "wb")
    try:
        fh.write(
            f"YUV4MPEG2 W{clip.width} H{clip.height} "
            f"F{fps[0]}:{fps[1]} I{interlace} A{aspect} C{cs}\n".encode()
        )
        write_y4m_frames(fh, clip, window=window)
    finally:
        if close:
            fh.close()


def write_y4m_frames(fh: BinaryIO, clip: Clip, window: int | None = None) -> None:
    """Append FRAME records to an already-headered stream (the incremental
    half of write_y4m — used by windowed/streaming processing).

    Each plane is copied to the host and converted to the stream dtype ONCE
    for the whole clip; the per-frame writes hand the file the plane's own
    buffer (zero-copy).  ``window``: the call id of its spans."""
    dt = _sample_dtype(clip.format.component_size)
    with span(DOWNLOAD, call=window) as sp:
        hosts = [p.cpu().numpy() for p in clip.planes]
        if sp:
            sp.set(frames=clip.num_frames, bytes=sum(h.nbytes for h in hosts))
    with span(SERIALIZE, call=window):
        arrs = [np.ascontiguousarray(h).astype(dt, copy=False) for h in hosts]
    with span(WRITE, call=window) as sp:
        for n in range(clip.num_frames):
            fh.write(b"FRAME\n")
            for p in arrs:
                fh.write(p[n].data)
        if sp:
            nbytes = clip.num_frames * (6 + sum(p[0].nbytes for p in arrs))
            sp.set(bytes=nbytes)
            count("frames_out", clip.num_frames)
            count("bytes_written", nbytes)
