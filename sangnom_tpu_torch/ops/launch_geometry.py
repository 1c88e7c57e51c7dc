"""Launch geometry that the kernel launchers share: a one-block walk's
threads, a row split over blocks, the cluster limit, and the row grids of
the prepare and finalize kernels.  Pure Python; the launchers
(``ops/deint_kernel``, ``ops/pool_kernel``, ``parallel/shard_kernel``)
import it and it imports none of them."""

from __future__ import annotations

# The most columns one block of a one-block walk takes (`launch_shape`, 8 a
# thread past 2048): the pool walk's reach (ops/pool_kernel.walk_plan).
MAX_COLS = 8192
# The most blocks a cluster takes (the portable limit on sm_90).
MAX_CLUSTER = 8
# Threads a block of the prepare and finalize grids (pool.cu, shard.cu).
ROW_THREADS = 256


def launch_shape(S: int) -> tuple[int, int]:
    """(columns per thread, threads per block) covering S columns of a
    one-block walk: thread t owns the contiguous columns t*cols ..
    t*cols+cols-1; one column per thread up to 512 columns, else 4 columns
    per thread (<= 512 threads), else 8 (<= 1024 threads).  The field
    kernel is instantiated for 1 and 4 columns and takes at most
    ``deint_kernel.FIELD_COLS``; the pool walk (``ops/pool_kernel``) for
    all three.  (A 2-column build spilled 1 KB per thread under ptxas for
    sm_90a and ran the 1080 chroma launch 5x slower than 4 columns on an
    H100: 12.0 against 2.4 ms.)"""
    for cols, max_threads in ((1, 512), (4, 512), (8, 1024)):
        n = -(-S // cols)
        if n <= max_threads:
            return cols, max(32, -(-n // 32) * 32)
    raise ValueError(f"plane too wide for the CUDA kernel: {S} smoothed columns "
                     f"(at most {MAX_COLS})")


def least_split(cut, width: int, cap: int, k0: int = 1) -> int:
    """The least k >= ``k0`` that cuts a row of ``width`` columns into
    blocks of at most ``cap`` columns: ``cut(k)`` gives the cut's (n, W_loc,
    H), n blocks of W_loc own columns with a halo of H columns on each inner
    side, or None where k does not cut the row; it fits where
    `block_width` (n, W_loc, H) <= ``cap``."""
    for k in range(k0, width + 1):
        c = cut(k)
        if c is not None and block_width(*c) <= cap:
            return k
    raise ValueError(f"width {width}: no split into blocks of at most {cap} columns")


def block_width(n_space: int, W_loc: int, H: int) -> int:
    """The widest block: an inner shard's W_loc + 2H (W_loc + H with two
    shards, the whole plane with one)."""
    return W_loc + min(n_space - 1, 2) * H


def row_blocks(rows: int, w: int, frames: int) -> int:
    """Blocks of the prepare and finalize grids of pool.cu and shard.cu
    (``row_grid``)."""
    return -(-w // ROW_THREADS) * min(rows, 65535) * frames
