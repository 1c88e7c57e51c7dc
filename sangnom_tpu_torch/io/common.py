"""Shared I/O plumbing for the y4m and raw readers/writers (numpy only)."""

from typing import BinaryIO, Callable, Optional, Union

import numpy as np

# Per-chunk preallocation budget (bytes) for unknown-length stream reads:
# big enough to amortize the final per-chunk concatenate, small enough that
# the trim waste on short clips and the chunk allocation itself stay
# bounded regardless of frame size (a frame-count bound would preallocate
# multi-GB chunks for 4K high-bit frames).  Tests monkeypatch this to
# force the multi-chunk paths.
CHUNK_BYTES = 256 * 2**20
# Frame-count ceiling per chunk (keeps the per-chunk Python loop and the
# trim granularity sane for tiny frames).
CHUNK_FRAMES_MAX = 4096


def _open(f: Union[str, BinaryIO], mode: str):
    """(file_handle, we_opened_it): open paths, pass handles through."""
    if isinstance(f, (str, bytes)):
        return open(f, mode), True
    return f, False


def readinto_full(fh, view: memoryview) -> int:
    """Fill a writable memoryview from ``fh``, looping over short reads
    (pipes and sockets deliver partial buffers); returns bytes read —
    less than ``len(view)`` only at EOF.  Handles without readinto (rare;
    any file-like object works) fall back to a read()+copy loop with the
    same short-read/EOF semantics (a None return — non-blocking handles —
    counts as EOF)."""
    readinto = getattr(fh, "readinto", None)
    got = 0
    if readinto is None:
        while got < len(view):
            data = fh.read(len(view) - got)
            if not data:
                break
            view[got : got + len(data)] = data
            got += len(data)
        return got
    while got < len(view):
        n = readinto(view[got:])
        if not n:
            break
        got += n
    return got


def read_frames_chunked(
    fh,
    geom: list,
    dt: np.dtype,
    max_frames: Optional[int],
    prologue: Optional[Callable[[], bool]] = None,
    truncated_msg: str = "truncated frame",
) -> list:
    """Stream whole frames into preallocated per-plane arrays — ONE copy
    from the stream (readinto), no per-frame staging buffers.

    ``geom``: [(pw, ph)] per plane; ``dt``: the stream dtype.
    ``prologue``: called before each frame; returns False at EOF (and may
    raise for malformed streams) — e.g. the y4m FRAME-marker readline.
    Without a prologue (raw streams), EOF is a zero-byte read at the first
    plane of a frame; any other short read raises ``truncated_msg``.

    Returns per-plane [n, ph, pw] arrays (n >= 1), or [] at immediate EOF.
    Unknown-length streams grow in CHUNK_BYTES-bounded chunks, concatenated
    once at the end.
    """
    fbytes = [pw * ph * dt.itemsize for pw, ph in geom]
    frame_bytes = sum(fbytes)
    chunk_cap = max(1, min(CHUNK_FRAMES_MAX, CHUNK_BYTES // max(1, frame_bytes)))

    chunks = []  # per-chunk lists of per-plane arrays
    total = 0
    while max_frames is None or total < max_frames:
        cap = (chunk_cap if max_frames is None
               else min(chunk_cap, max_frames - total))
        arrs = [np.empty((cap, ph, pw), dt) for pw, ph in geom]
        views = [memoryview(a).cast("B") for a in arrs]
        got = 0
        eof = False
        for i in range(cap):
            if prologue is not None and not prologue():
                eof = True
                break
            for k, (v, fb) in enumerate(zip(views, fbytes)):
                n = readinto_full(fh, v[i * fb : (i + 1) * fb])
                if n == fb:
                    continue
                if k == 0 and n == 0 and prologue is None:
                    eof = True
                    break
                raise ValueError(truncated_msg)
            if eof:
                break
            got += 1
        if got:
            chunks.append([a[:got] for a in arrs])
            total += got
        if eof or got < cap:
            break
    if not chunks:
        return []
    if len(chunks) == 1:
        return chunks[0]
    return [np.concatenate([c[k] for c in chunks]) for k in range(len(geom))]
