"""Clip: the batched frame container.

Each plane is one tensor of shape ``[num_frames, plane_height, plane_width]``
in the format's storage dtype, all on one device, so a whole clip goes
through the filter as a few batched launches.  Per-frame parity stays a host
numpy array: order=0 resolves field offsets on the host, as AviSynth's
GetParity is a host call (reference src/SangNom2.cpp:338).
"""

from __future__ import annotations

from typing import Any, Optional, Sequence

import numpy as np
import torch

from sangnom_tpu_torch.core.formats import VideoFormat, get_format


def where_storage(cond: torch.Tensor, a: torch.Tensor,
                  b: torch.Tensor) -> torch.Tensor:
    """``torch.where`` for storage-dtype planes.  CUDA has no uint16
    ``where``, so 16-bit planes select through a bit-identical int16 view."""
    if a.dtype == torch.uint16:
        return torch.where(cond, a.view(torch.int16),
                           b.view(torch.int16)).view(torch.uint16)
    return torch.where(cond, a, b)


class Clip:
    """A batched planar video clip.

    Attributes:
      planes: tuple of tensors, one per plane, each ``[N, Hp, Wp]`` in the
        format's storage dtype, on one device.
      format: the `VideoFormat`.
      parity: per-frame field parity as a host ``[N]`` bool numpy array
        (True = top field first), consulted by ``order=0``; ``None`` means
        constant `tff`.
      tff: default parity used when `parity` is None.
      props: free-form frame properties, carried through the filter.
    """

    def __init__(
        self,
        planes: Sequence[torch.Tensor],
        format: VideoFormat | str,
        parity: Optional[np.ndarray] = None,
        tff: bool = True,
        props: Optional[dict[str, Any]] = None,
    ):
        fmt = get_format(format) if isinstance(format, str) else format
        self.planes = tuple(planes)
        self.format = fmt
        self.parity = None if parity is None else np.asarray(parity, dtype=bool)
        self.tff = bool(tff)
        self.props = dict(props) if props else {}

    # -- geometry ---------------------------------------------------------
    @property
    def num_frames(self) -> int:
        return int(self.planes[0].shape[0])

    @property
    def height(self) -> int:
        return int(self.planes[0].shape[1])

    @property
    def width(self) -> int:
        return int(self.planes[0].shape[2])

    @property
    def num_planes(self) -> int:
        return len(self.planes)

    @property
    def device(self) -> torch.device:
        return self.planes[0].device

    def get_parity(self, n: int) -> bool:
        """Parity of frame ``n`` (AviSynth GetParity)."""
        if self.parity is not None:
            return bool(self.parity[n])
        return self.tff

    def parity_array(self) -> np.ndarray:
        """Per-frame parity as a host bool array."""
        if self.parity is not None:
            return self.parity
        return np.full((self.num_frames,), self.tff, dtype=bool)

    # -- construction and conversion ----------------------------------------
    @classmethod
    def from_numpy(
        cls,
        planes: Sequence[np.ndarray],
        format: VideoFormat | str,
        device: torch.device | str = "cuda",
        parity: Optional[np.ndarray] = None,
        tff: bool = True,
        props: Optional[dict[str, Any]] = None,
    ) -> "Clip":
        """A clip from numpy planes on ``device``.  The default is "cuda", so
        a machine without a GPU fails here unless the caller asks for the
        CPU."""
        fmt = get_format(format) if isinstance(format, str) else format
        tensors = [
            torch.from_numpy(
                np.ascontiguousarray(np.asarray(p, dtype=fmt.np_dtype))
            ).to(device)
            for p in planes
        ]
        return cls(tensors, fmt, parity=parity, tff=tff, props=props)

    def to_numpy(self) -> list[np.ndarray]:
        """The planes as host numpy arrays in the storage dtype."""
        return [p.cpu().numpy() for p in self.planes]

    def __getitem__(self, s) -> "Clip":
        """Frame-range slicing: clip[2:5] -> a 3-frame Clip; a single int
        yields a 1-frame Clip (bounds-checked)."""
        if isinstance(s, int):
            n = self.num_frames
            if not -n <= s < n:
                raise IndexError(f"frame {s} out of range for {n} frames")
            s = s % n
            s = slice(s, s + 1)
        parity = self.parity[s] if self.parity is not None else None
        return Clip(
            [p[s] for p in self.planes], self.format,
            parity=parity, tff=self.tff, props=self.props,
        )

    @classmethod
    def concat(cls, *clips: "Clip") -> "Clip":
        """Concatenate clips along the frame axis (formats must match).
        Differing field dominance is kept by materializing the per-frame
        parity array."""
        first = clips[0]
        if any(c.format.name != first.format.name for c in clips):
            raise ValueError("concat: mismatched formats")
        planes = [
            torch.cat([c.planes[i] for c in clips], dim=0)
            for i in range(first.num_planes)
        ]
        if (any(c.parity is not None for c in clips)
                or any(c.tff != first.tff for c in clips)):
            parity = np.concatenate([c.parity_array() for c in clips])
        else:
            parity = None
        return cls(planes, first.format, parity=parity, tff=first.tff,
                   props=first.props)

    def with_planes(self, planes: Sequence[torch.Tensor], format=None) -> "Clip":
        """A clip with new planes and the same parity and props (the frame
        property copy of reference src/SangNom2.cpp:344)."""
        return Clip(
            planes,
            self.format if format is None else format,
            parity=self.parity,
            tff=self.tff,
            props=self.props,
        )

    def __repr__(self) -> str:
        return (
            f"Clip({self.format.name}, frames={self.num_frames}, "
            f"{self.width}x{self.height}, planes={self.num_planes}, "
            f"device={self.device})"
        )
