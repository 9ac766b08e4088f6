"""The least work of the program's fused kernels, and the card's peaks:
the yardstick of the ``roofline_share.*`` metrics.

Copied from the program's ``kernels/work.py`` (its per-row flops) and
frozen here, with two changes: every input is counted once at the
unpadded shapes the kernel is given (M clusters, ``rows`` real rows, N
stations), not at the padded ``mp``, ``rowsp`` and ``npad`` the launch
works on; and the operations' time is the flops over the float32 peak
alone, with no on-chip gather rate (that rate is derived, not
published).  Stdlib only.

Peaks of one H100 SXM from NVIDIA's data sheet (700 W): HBM3 at
3.35 TB/s, 67 TFLOP/s float32 outside the tensor cores (the kernels
compute in exact float32 and use no tensor core).
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12

# real float32 operations per (cluster, channel, row): the model's two
# 2x2 complex products (8 complex multiply-adds each, 8 flops apiece);
# the gradient adds the model again, C J_q^H, dJ_p, dA and dJ_q
MODEL_FLOPS = 128
BWD_FLOPS = MODEL_FLOPS + 4 * 64
RESIDUAL_FLOPS = 40  # per (channel, row): the masked residual and its cost


def _model_inputs(M: int, nc: int, N: int, F: int, rows: int) -> int:
    """Bytes of the model's inputs: the gain tables (re and im, 4 x M nc
    x N float32 each), the coherencies (M x F x 8 x rows float32), the
    station indices (2 x rows int32) and, with hybrid chunks, the chunk
    map (M x rows int32)."""
    return (2 * 4 * M * nc * N * 4 + M * F * 8 * rows * 4 + 2 * rows * 4
            + (M * rows * 4 if nc > 1 else 0))


def fused_cost(M: int, nc: int, N: int, F: int, rows: int) -> dict:
    """#3 (forward: the cost) and #4 (backward: the gain gradients) on a
    tile: {"fwd": (bytes, flops), "bwd": (bytes, flops)}; both read the
    model's inputs, the visibilities (F x 8 x rows float32), the mask
    (F x rows) and nu; #3 writes one float, #4 the two gradient tables."""
    inputs = _model_inputs(M, nc, N, F, rows) + F * 8 * rows * 4 \
        + F * rows * 4 + 4
    tables = 2 * 4 * M * nc * N * 4
    cells = M * F * rows
    return {"fwd": (inputs + 4, MODEL_FLOPS * cells + RESIDUAL_FLOPS * F * rows),
            "bwd": (inputs + tables,
                    BWD_FLOPS * cells + 2 * RESIDUAL_FLOPS * F * rows)}


def fused_predict(M: int, nc: int, N: int, F: int, rows: int) -> tuple:
    """#1 (the model of every cluster corrupted by its gains): reads the
    model's inputs, writes the model (F x 8 x rows float32)."""
    return (_model_inputs(M, nc, N, F, rows) + F * 8 * rows * 4,
            MODEL_FLOPS * M * F * rows)


def least_seconds(nbytes: int, flops: int) -> float:
    """The least time of that work on the card: bytes over the memory
    rate or flops over the float32 rate, whichever is longer."""
    return max(nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S)
