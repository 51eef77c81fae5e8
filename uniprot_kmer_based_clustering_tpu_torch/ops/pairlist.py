"""The device pair list: the one format every exact extractor appends to
and fetches from.

A pair list on the device is three int32 slot arrays (i, j, count) and an
int64 cursor that stays on the device (:func:`new_pair_buffers`). Unused
slots hold the sentinels :data:`IMAX` (i and j) and −1 (count); a
surviving pair's count is > threshold ≥ 0, and the sentinel sorts past
every real row index, so the occupied prefix of the (i, j)-sorted
buffers is the pair list.

- **Capacity.** :func:`vcap_bucket` is the JAX package's bucketed rule
  for an exact survivor count; K1 (``ops.stats.stats_from_counts_into``
  with ``pairs``) appends into :data:`EPILOGUE_PAIR_CAP` slots on the
  strip schedule. A buffer that the appends below write carries one
  append window of slack past its usable capacity (:func:`append_window`,
  :data:`APPEND_LANES`).
- **Append** (:func:`sort_compact_append`, :func:`append_block`,
  :func:`append_rows`): a window is ordered survivors first by a stable
  sort of its keep flag and written whole at the cursor, which advances
  by the survivors; the next append overwrites the sentinel tail. Nothing
  is sized by the data, so no append waits for the host.
- **Survivors promised.** :func:`tile_survivors` reads a sweep's exact
  tile hits under the AMR gate; every extractor compares its cursor with
  their sum.
- **Fetch** (:func:`finalize_pairs`): one read of the cursor, checked
  against that sum (:func:`check_cursor`), then the (i, j) sort on the
  device (:func:`sorted_pairs`) and one copy to the host, as int32
  [M, 3] or in the packed ``i:24 | j:24 | count:16`` int64 format
  (:func:`unpack_pairs`, :func:`pairs_as_array`, :func:`packed_key`,
  :func:`packed_pair`); :func:`merge_pairs` joins two fetched lists.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

#: Sentinel of the i and j slots no pair occupies.
IMAX = np.int32(np.iinfo(np.int32).max)

#: Slots of the pair buffers K1 appends to on the strip schedule, and on
#: each card of a mesh's appending sweep (786,432 bytes): over 100 times
#: the pairs of the 10,619-protein AMR corpus. More survivors than this
#: (on one card) take two-pass extraction.
EPILOGUE_PAIR_CAP = 1 << 16

#: Lanes of one windowed append (its sort temporaries and the buffers'
#: slack scale with it).
APPEND_LANES = 1 << 22


def new_pair_buffers(vcap: int, device):
    """Fresh pair buffers on ``device``: (bi, bj, bc, cursor) with
    sentinel slots (bi = bj = IMAX, bc = -1) and an int64 cursor of 0
    that stays on the device."""
    return (
        torch.full((vcap,), int(IMAX), dtype=torch.int32, device=device),
        torch.full((vcap,), int(IMAX), dtype=torch.int32, device=device),
        torch.full((vcap,), -1, dtype=torch.int32, device=device),
        torch.zeros((), dtype=torch.int64, device=device),
    )


def vcap_bucket(total: int, space: Optional[int] = None) -> int:
    """Bucketed pair-buffer capacity for an exact survivor count, the JAX
    package's rule (it enters the stream engine's budget, so both packages
    block alike). ``space`` caps the bucket at the candidate space."""
    g = 1 << 17 if total >= 1 << 17 else 1 << 14
    vcap = max(1, (total + g - 1) // g * g)
    if space is not None:
        vcap = max(1, min(space, vcap))
    return vcap


def append_window(block: int) -> int:
    """Lanes of the largest :func:`append_rows` window of a counts block
    at most ``block`` columns wide and high: at most :data:`APPEND_LANES`
    lanes (or one row), never more than the block. Buffers that take such
    appends carry this much slack past their capacity."""
    return min(block * block, max(block, APPEND_LANES))


def tile_survivors(tile_hits, cross_amr_only: bool) -> np.ndarray:
    """The survivors of each tile, int64 [nT], from a sweep's exact
    ``tile_hits`` [nT, 2]: the cross-class lane, plus the same-class lane
    when the AMR gate is off."""
    tile_hits = np.asarray(tile_hits)
    hits = tile_hits[:, 0].astype(np.int64)
    if not cross_amr_only:
        hits += tile_hits[:, 1]
    return hits


def _survivors_first(keep):
    """(the window's flat indices ordered survivors first, the survivor
    count as a device scalar): a stable sort by the keep flag. Nothing is
    sized by the data."""
    k = keep.reshape(-1)
    return torch.argsort((~k).to(torch.uint8), stable=True), k.sum()


def _append_survivors(gbi, gbj, gbc, cursor, kept, gi_s, gj_s, c_s):
    """Write one window, already ordered survivors first, at the cursor:
    the first ``kept`` lanes carry the survivors, the rest sentinels. The
    positions are ``cursor + arange(window)`` as an index write (the
    cursor never leaves the device); a position past the buffers goes to
    their last slot, which only happens in a run that has overflowed and
    whose buffers are discarded."""
    lane = torch.arange(gi_s.shape[0], device=gi_s.device)
    live = lane < kept
    pos = torch.clamp(cursor + lane, max=gbi.shape[0] - 1)
    gbi[pos] = torch.where(live, gi_s, int(IMAX))
    gbj[pos] = torch.where(live, gj_s, int(IMAX))
    gbc[pos] = torch.where(live, c_s, -1)
    return gbi, gbj, gbc, cursor + kept


def sort_compact_append(gbi, gbj, gbc, cursor, keep, gi, gj, counts):
    """Append one window's survivors to the pair buffers, in place, with
    no host synchronisation.

    ``keep`` (bool), ``gi``, ``gj`` and ``counts`` (int32) share one
    shape, the window. The window is sorted by the keep flag (survivors
    first; the order within a window is irrelevant, every consumer sorts
    the whole list by (i, j)), its tail set to sentinels, and the whole
    window written at ``cursor`` (an int64 scalar on the device). The
    next append starts at ``cursor + kept`` and overwrites this one's
    sentinel tail, so the buffers stay [real pairs][sentinels].

    Buffers MUST carry at least one window of slack past the usable
    capacity (``new_pair_buffers(vcap + window)``), so that no write of
    a run that fits is ever displaced. In a run that overflows the cursor
    walks past the buffers; those buffers are discarded (the caller
    decides overflow from the sweep's own exact int64 total, never from
    the cursor).

    Returns (gbi, gbj, gbc, cursor + kept).
    """
    order, kept = _survivors_first(keep)
    return _append_survivors(
        gbi, gbj, gbc, cursor, kept, gi.reshape(-1)[order],
        gj.reshape(-1)[order], counts.reshape(-1)[order],
    )


def append_block(gbi, gbj, gbc, cursor, keep, counts, i0: int, j0: int,
                 *, transposed: bool = False):
    """:func:`sort_compact_append` for a counts block at global offset
    (i0, j0): the row and column of a survivor follow from its flat
    index, so no index matrices are built. ``transposed`` writes each
    pair as (column, row), for a block whose columns lie below its
    rows."""
    order, kept = _survivors_first(keep)
    cols = keep.shape[1]
    gi = (i0 + order // cols).to(torch.int32)
    gj = (j0 + order % cols).to(torch.int32)
    if transposed:
        gi, gj = gj, gi
    return _append_survivors(gbi, gbj, gbc, cursor, kept, gi, gj,
                             counts.reshape(-1)[order])


def append_rows(gbi, gbj, gbc, cursor, keep, counts, i0: int, j0: int,
                *, transposed: bool = False):
    """:func:`append_block` in windows of whole rows, at most
    :data:`APPEND_LANES` lanes each (one row when a row is wider), so the
    buffers need only :func:`append_window` lanes of slack whatever the
    block's height."""
    bufs = gbi, gbj, gbc, cursor
    rows, cols = keep.shape
    step = max(1, APPEND_LANES // cols)
    for a in range(0, rows, step):
        bufs = append_block(*bufs, keep[a : a + step], counts[a : a + step],
                            i0 + a, j0, transposed=transposed)
    return bufs


def sorted_pairs(gi, gj, cnt):
    """Device sort of (i, j, count) by (i, j) -> int32 [M, 3]; sentinel
    slots of pair buffers sort to the tail."""
    order = torch.argsort((gi.to(torch.int64) << 32) | gj.to(torch.int64))
    return torch.stack(
        [x[order].to(torch.int32) for x in (gi, gj, cnt)], dim=1)


# Packed pair list: one int64 a pair, i(24) | j(24) | count(16). Sorting
# the packed value is the canonical (i, j) sort, because a pair occurs
# once and so the count bits never decide an order. Valid when every row
# index is < 2^23 (the i field sits in bits 40-63 of a signed int64) and
# every count < 2^16; the fetch checks both and falls back to [M, 3].
_PACK_I_SHIFT = 40
_PACK_J_SHIFT = 16
_PACK_FIELD_MASK = (1 << 24) - 1
_PACK_ROW_LIMIT = 1 << 23
_PACK_COUNT_LIMIT = 1 << 16


def _pack_sort_fetch(bi, bj, bc, total: int):
    """The first ``total`` buffer slots packed to int64, sorted on the
    device and copied to the host; None when a count reaches 2^16 (the
    pack would corrupt it: callers fall back to [M, 3])."""
    bc = bc[:total].to(torch.int64)
    if total and int(bc.max()) >= _PACK_COUNT_LIMIT:
        return None
    packed = (
        (bi[:total].to(torch.int64) << _PACK_I_SHIFT)
        | (bj[:total].to(torch.int64) << _PACK_J_SHIFT)
        | bc
    )
    return torch.sort(packed).values.cpu().numpy()


def unpack_pairs(packed: np.ndarray) -> np.ndarray:
    """Decode a packed int64 pair list to the canonical [M, 3] int32
    matrix."""
    out = np.empty((len(packed), 3), np.int32)
    out[:, 0] = packed >> _PACK_I_SHIFT
    out[:, 1] = (packed >> _PACK_J_SHIFT) & _PACK_FIELD_MASK
    out[:, 2] = packed & (_PACK_COUNT_LIMIT - 1)
    return out


def pairs_as_array(pairs: np.ndarray) -> np.ndarray:
    """Canonical [M, 3] int32 view of either pair-list format (packed
    int64 [M] or already [M, 3])."""
    return unpack_pairs(pairs) if pairs.ndim == 1 else pairs


def packed_key(i: int, j: int) -> int:
    """Packed value of pair (i, j) with count 0: the ``searchsorted``
    lower bound of the pair in a sorted packed list (a stored pair's
    value lies in [key, key + 2^16))."""
    return (int(i) << _PACK_I_SHIFT) | (int(j) << _PACK_J_SHIFT)


def packed_pair(v) -> tuple:
    """Decode one packed int64 to (i, j, count)."""
    v = int(v)
    return (
        v >> _PACK_I_SHIFT,
        (v >> _PACK_J_SHIFT) & _PACK_FIELD_MASK,
        v & (_PACK_COUNT_LIMIT - 1),
    )


def merge_pairs(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """The union of two fetched pair lists in canonical (i, j) order:
    packed when both are packed, else int32 [M, 3]."""
    if a.ndim == 1 and b.ndim == 1:
        # packed values sort exactly like (i, j)
        return np.sort(np.concatenate([a, b]))
    c = np.concatenate([pairs_as_array(a), pairs_as_array(b)])
    return c[np.lexsort((c[:, 1], c[:, 0]))]


def fetch_sorted_pairs(bi, bj, bc, total: int, pair_format: str,
                       n_rows: int) -> np.ndarray:
    """Sort and fetch the pair list from buffers whose first ``total``
    slots are the survivors (the appends keep them a prefix).
    ``pair_format="packed"`` fetches the packed int64 layout when the
    ranges fit (row indices bounded by ``n_rows``, counts checked on the
    device), else int32 [M, 3]."""
    if pair_format == "packed" and n_rows < _PACK_ROW_LIMIT:
        arr = _pack_sort_fetch(bi, bj, bc, total)
        if arr is not None:
            return arr
    return sorted_pairs(bi[:total], bj[:total], bc[:total]).cpu().numpy()


def check_cursor(cursor, expected_total: int) -> None:
    """Read the cursor (the one synchronisation of a fetch) and raise
    when the appended count disagrees with the sweep's exact survivors:
    a capacity fault must never truncate the pair list."""
    count = int(cursor)
    if count != expected_total:
        raise AssertionError(
            f"extraction compacted {count} pairs, sweep stats promised "
            f"{expected_total}"
        )


def finalize_pairs(buffers, expected_total: int, pair_format: str = "arr3",
                   n_rows: int = 0) -> np.ndarray:
    """:func:`check_cursor`, then sort and fetch exactly
    ``expected_total`` rows (:func:`fetch_sorted_pairs`).
    ``pair_format="packed"`` needs ``n_rows``, the row-index bound."""
    bi, bj, bc, cursor = buffers
    check_cursor(cursor, expected_total)
    if not n_rows:
        pair_format = "arr3"
    return fetch_sorted_pairs(bi, bj, bc, expected_total, pair_format,
                              n_rows)
