"""Work counts of one call, from its shapes: the algorithm's bytes and int32
operations, whatever implements the filter.  One module a filter mode
(`main`, `pool`), each with ``call_work(config, traffic) -> (bytes, ops)``;
the workload file names its mode under "work"."""

from __future__ import annotations


def planes_of(config: dict) -> list[tuple[int, int]]:
    """(width, height) of each plane of the configuration's frames (its
    ``plane_shifts``: each plane's width and height shifts from luma)."""
    return [(config["width"] >> sw, config["height"] >> sh)
            for sw, sh in config["plane_shifts"]]


def sample_bytes(config: dict) -> int:
    """Bytes a stored sample takes: 1 at 8 bits, 2 at 9-16 (uint16)."""
    return 1 if config["bits"] == 8 else 2


def stride_of(luma_width: int) -> int:
    """The error buffers' stride: the luma width rounded up to 32."""
    return -(-luma_width // 32) * 32


def field_passes(config: dict, traffic: dict) -> list[tuple[int, int, int]]:
    """(fields, kept rows, width) of each plane over one call: the bob makes
    two output frames of each input frame, each interpolating one field;
    order 1 or 2 interpolates one field a frame."""
    entry = config["filter"]["entry"]
    n = traffic["frames"] * (2 if entry == "bob" else 1)
    return [(n, h // 2, w) for w, h in planes_of(config)]
