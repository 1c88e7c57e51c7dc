"""Clip I/O: YUV4MPEG2 (.y4m) and raw-planar readers/writers.

y4m is the host-boundary format of deinterlacer pipelines (ffmpeg, mpv and
VapourSynth all speak it).  Readers take the ``device`` the clip goes to,
"cuda" unless the caller asks for another.
"""

from sangnom_tpu_torch.io.raw import frame_size_bytes, read_raw, write_raw  # noqa: F401
from sangnom_tpu_torch.io.y4m import (  # noqa: F401
    iter_y4m,
    read_y4m,
    write_y4m,
    write_y4m_frames,
)
