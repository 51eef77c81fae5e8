"""The table of peaks and the arithmetic of the rooflines.

Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet; dense
rates, at the full 700 W power limit): every roofline share is stated
against them, with the card's power limit and clock printed beside the
run. The byte counts follow the statistics-epilogue bound of the port's
``chip_smoke.py`` (``needed_pairs``, ``epilogue_bound_ms``): each needed
count, the classes and the outputs once each, at the HBM rate.
"""

from __future__ import annotations

PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "int8_ops_s": 1979e12,
        "hbm_bytes_s": 3.35e12,
    },
}
ROW_STAT_LANES = 8
TILE_HIT_LANES = 2


def peak(kind: str, name: str) -> float:
    """The published peak ``name`` of the card ``kind``
    (``torch.cuda.get_device_name``); a card the table lacks raises."""
    if kind not in PEAKS:
        raise KeyError(f"no published peaks for {kind!r}: add them to "
                       "benchmark/peaks.py")
    return PEAKS[kind][name]


def int_mm_ops(shapes) -> int:
    """Operations of one ``torch._int_mm`` call from its operand shapes
    ``[[M, K], [K, N]]``: a multiply-add counts 2."""
    (m, k), (_, n) = shapes[0], shapes[1]
    return 2 * m * n * k


def epilogue_needed_bytes(n: int, tile: int) -> int:
    """Bytes that the statistics epilogue of one whole sweep has to move:
    the int32 count of every pair i < j < n read once, the n classes read
    once, and the outputs written once (8 int32 lanes a row; 2 lanes a
    tile pair ti <= tj of ``tile``-row tiles). The same for every schedule
    and kernel that computes the sweep."""
    tiles = -(-n // tile)
    ints = (n * (n - 1) // 2 + n + ROW_STAT_LANES * n
            + TILE_HIT_LANES * tiles * (tiles + 1) // 2)
    return 4 * ints
