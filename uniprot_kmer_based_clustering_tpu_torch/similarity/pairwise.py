"""Single-device pairwise similarity: sweep statistics + exact pair list.

Counterpart of the JAX package's ``similarity/pairwise.py`` for the
engines ``auto``, ``mxu``, ``popcount``, ``xla``, ``native`` and
``stream``.

- Two-pass extraction (:func:`extract_pairs`): pass 1 is the sweep,
  which reports exact per-tile hit counts; pass 2 recomputes only the hit
  tiles (a run of adjacent hit tiles in one tile row as one product),
  compacts the survivors with ``torch.nonzero``, sorts them on the device
  by ``i·N_pad + j`` and copies the pair list to the host once.
- Fused extraction (:func:`extract_pairs_fused`, ``extract="fused"`` on
  the scan schedule): the sweep kept each sub-tile's survivors; they are
  compacted and sorted the same way, and the sub-tiles whose exact hit
  count exceeded the capacity are redone by two-pass.
- ``engine="stream"`` (``ops/stream.py``) keeps the packed matrix on the
  host and streams row blocks through the device; its extractors append
  survivors to global pair buffers on the device (:func:`_new_pair_buffers`,
  sized by :func:`_vcap_bucket`) behind a cursor that stays on the device,
  and :func:`_finalize_pairs` sorts and fetches them once, as int32
  [M, 3] or in the packed ``i:24 | j:24 | count:16`` int64 format
  (:func:`unpack_pairs`, :func:`pairs_as_array`, :func:`packed_key`,
  :func:`packed_pair`).

The in-core extractors size their own output with ``nonzero``; the TPU
compaction workarounds of the in-core path (superblock coalescing, top_k
selection in pass 2) are not carried over.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from uniprot_kmer_based_clustering_tpu_torch.config import PipelineConfig
from uniprot_kmer_based_clustering_tpu_torch.device import resolve_device
from uniprot_kmer_based_clustering_tpu_torch.io import native
from uniprot_kmer_based_clustering_tpu_torch.kmers.bitset import BitsetMatrix
from uniprot_kmer_based_clustering_tpu_torch.ops.bitmul import (
    FusedCandidates,
    int8_gemm,
    survivor_mask,
    sweep_mxu,
    unpack_words_to_int8,
)
from uniprot_kmer_based_clustering_tpu_torch.ops.popcount import sweep
from uniprot_kmer_based_clustering_tpu_torch.state import (
    bitset_to_torch,
    classes_to_torch,
    weights_to_torch,
)
from uniprot_kmer_based_clustering_tpu_torch.utils.timing import span

#: Counts of the most recent :func:`pairwise_similarity` call that swept
#: on the device (engines ``mxu``, ``popcount``, ``xla``), the
#: ``ops.stream.last_trace`` convention: ``upload_bytes`` (the words,
#: classes, weights and the fused keep mask sent to the device),
#: ``hit_tiles``, ``extract_products`` (pass-2 ``int8_gemm`` calls, one a
#: run of adjacent hit tiles), ``extract_syncs`` (every host wait of
#: extraction: a ``nonzero`` a product or a boolean-mask compaction, and
#: the final fetch) and ``pairs``. Times are the spans' (``utils.timing``).
last_trace: dict = {}


def _new_trace() -> dict:
    return dict(upload_bytes=0, hit_tiles=0, extract_products=0,
                extract_syncs=0, pairs=0)


@dataclasses.dataclass
class PairwiseResult:
    """Aggregate similarity statistics plus the surviving pair list.

    Attributes map to the reference's parity counters:
      cross_weight: Σ shared-kmer counts over cross-AMR pairs.
      cross_pairs: distinct cross-AMR pairs with ≥1 shared k-mer.
      cross_over: pairs over the alignment threshold.
      cross_max: maximum shared-k-mer count over cross-AMR pairs.
      same_*: the same statistics for class-equal pairs.
      pairs: int32 [M, 3] — (i, j, shared_count) for surviving pairs,
        sorted by (i, j). With cross_amr_only=False both populations
        survive the gate.
      cross_amr_only: the gate mode this result was produced under —
        drives which lanes parity_counters() surfaces.
    """

    cross_weight: int
    cross_pairs: int
    cross_over: int
    cross_max: int
    same_weight: int
    same_pairs: int
    same_over: int
    same_max: int
    pairs: np.ndarray
    cross_amr_only: bool = True

    @classmethod
    def from_row_stats(
        cls, row_stats, pairs: np.ndarray, cross_amr_only: bool = True
    ) -> "PairwiseResult":
        """Assemble from the engines' canonical [N, 8] row statistics
        (ops.popcount.ROW_STAT_NAMES lane order)."""
        rs = np.asarray(row_stats).astype(np.int64)
        totals = rs.sum(axis=0)
        maxes = rs.max(axis=0)
        return cls(
            cross_weight=int(totals[0]),
            cross_pairs=int(totals[1]),
            cross_over=int(totals[2]),
            cross_max=int(maxes[3]),
            same_weight=int(totals[4]),
            same_pairs=int(totals[5]),
            same_over=int(totals[6]),
            same_max=int(maxes[7]),
            pairs=pairs,
            cross_amr_only=cross_amr_only,
        )

    def parity_counters(self) -> Dict[str, int]:
        """Counters matching stats.json / the reference's stderr output;
        with the AMR gate off they cover both populations."""
        if self.cross_amr_only:
            return {
                "edges_after_amr_filter": self.cross_weight,
                "pairs_after_merge": self.cross_pairs,
                "pairs_over_threshold": self.cross_over,
                "max_shared_kmers": self.cross_max,
            }
        return {
            "edges_after_amr_filter": self.cross_weight + self.same_weight,
            "pairs_after_merge": self.cross_pairs + self.same_pairs,
            "pairs_over_threshold": self.cross_over + self.same_over,
            "max_shared_kmers": max(self.cross_max, self.same_max),
        }


# Sentinel of unused slots in the global pair buffers: it sorts past
# every real row index, so the occupied prefix of the sorted buffers is
# the pair list. The count lane uses -1 (a surviving pair's score is
# > threshold >= 0).
_IMAX = np.int32(np.iinfo(np.int32).max)


def _new_pair_buffers(vcap: int, device):
    """Fresh global pair buffers on ``device``: (bi, bj, bc, cursor) with
    sentinel slots (bi = bj = INT32_MAX, bc = -1) and an int64 cursor of
    0 that stays on the device."""
    return (
        torch.full((vcap,), int(_IMAX), dtype=torch.int32, device=device),
        torch.full((vcap,), int(_IMAX), dtype=torch.int32, device=device),
        torch.full((vcap,), -1, dtype=torch.int32, device=device),
        torch.zeros((), dtype=torch.int64, device=device),
    )


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


def _sort_pairs(bi, bj, bc):
    """Device sort of the buffers by (i, j) -> int32 [len, 3]; sentinel
    slots sort to the tail."""
    order = torch.argsort((bi.to(torch.int64) << 32) | bj.to(torch.int64))
    return torch.stack([bi[order], bj[order], bc[order]], dim=1)


def _fetch_sorted_pairs(bi, bj, bc, total: int, pair_format: str,
                        n_rows: int) -> np.ndarray:
    """Sort and fetch the pair list from compacted global buffers whose
    first ``total`` slots are the survivors (the appends keep them a
    prefix). ``pair_format="packed"`` fetches the packed int64 layout when
    the ranges fit (row indices bounded by ``n_rows``, counts checked on
    the device), else int32 [M, 3]."""
    if pair_format == "packed" and n_rows < _PACK_ROW_LIMIT:
        arr = _pack_sort_fetch(bi, bj, bc, total)
        if arr is not None:
            return arr
    return _sort_pairs(bi[:total], bj[:total], bc[:total]).cpu().numpy()


def _vcap_bucket(total: int, space: Optional[int] = None) -> int:
    """Bucketed pair-buffer capacity for an exact survivor count, the JAX
    package's rule (it enters the stream engine's budget, so both packages
    block alike). ``space`` caps the bucket at the candidate space."""
    g = 1 << 17 if total >= 1 << 17 else 1 << 14
    vcap = max(1, (total + g - 1) // g * g)
    if space is not None:
        vcap = max(1, min(space, vcap))
    return vcap


def _finalize_pairs(buffers, expected_total: int, pair_format: str = "arr3",
                    n_rows: int = 0) -> np.ndarray:
    """Read the cursor (the one synchronisation), raise when the compacted
    count disagrees with the sweep's exact tile hits (a capacity fault
    must never truncate), then sort and fetch exactly ``expected_total``
    rows. ``pair_format="packed"`` needs ``n_rows``, the row-index bound."""
    bi, bj, bc, cursor = buffers
    count = int(cursor)
    if count != expected_total:
        raise AssertionError(
            f"extraction compacted {count} pairs, sweep stats promised "
            f"{expected_total}"
        )
    if not n_rows:
        pair_format = "arr3"
    return _fetch_sorted_pairs(bi, bj, bc, expected_total, pair_format,
                               n_rows)


def _tile_runs(ti: np.ndarray, tj: np.ndarray):
    """Runs of column-adjacent tiles within one tile row, from a
    row-major tile list: (ti, first tj, run length) each."""
    new = np.ones(len(ti), dtype=bool)
    new[1:] = (ti[1:] != ti[:-1]) | (tj[1:] != tj[:-1] + 1)
    starts = np.nonzero(new)[0]
    lengths = np.diff(np.append(starts, len(ti)))
    return zip(ti[starts], tj[starts], lengths)


# bytes of one unpacked int8 operand window of the two-pass extraction
_UNPACK_WINDOW_BYTES = 4 << 30


def _window_rows(n_pad: int, tile: int, k_bits: int) -> int:
    """Rows of the operand windows pass 2 unpacks: the whole matrix when
    it fits one window, else the largest tile-multiple divisor of N_pad
    that does."""
    if n_pad * k_bits <= _UNPACK_WINDOW_BYTES:
        return n_pad
    best = tile
    for rows in range(tile, n_pad + 1, tile):
        if n_pad % rows == 0 and rows * k_bits <= _UNPACK_WINDOW_BYTES:
            best = rows
    return best


def _sorted_pairs(gi, gj, cnt, n_pad: int):
    """Device sort of (i, j, count) by i·N_pad + j → int32 [M, 3]."""
    key, order = torch.sort(gi.to(torch.int64) * n_pad + gj)
    return torch.stack(
        [key // n_pad, key % n_pad, cnt[order].to(torch.int64)], dim=1
    ).to(torch.int32)


def extract_pairs(
    words,
    classes,
    tile_hits: np.ndarray,
    tiles,
    n: int,
    threshold: int,
    cross_amr_only: bool = True,
    weights=None,
    trace: Optional[dict] = None,
) -> np.ndarray:
    """Pass-2 exact pair recovery from the tiles that reported hits.

    ``words`` int32 [N_pad, W] and ``classes`` (int32, padded to N_pad
    with −1 or length n) on the sweep's device; ``tiles`` is the
    (ti, tj, tile) enumeration the sweep returned with ``tile_hits``.
    With ``weights`` (int8 [W*32]) the recovered values are the weighted
    scores. The bit matrix is unpacked in row windows of at most
    ``_UNPACK_WINDOW_BYTES`` (the whole matrix when it fits: 2.6 GB for
    the 10,619-protein corpus). Returns int32 [M, 3] (i, j, count)
    sorted by (i, j); raises when the compacted count disagrees with the
    sweep's promise. ``trace`` (a :data:`last_trace` dict) gains the hit
    tiles, the products and the host syncs.
    """
    trace = _new_trace() if trace is None else trace
    with span("extract.plan"):
        ti, tj, tile = tiles
        tile_hits = np.asarray(tile_hits)
        want = tile_hits[:, 0] > 0
        hits_per_tile = tile_hits[:, 0].astype(np.int64)
        if not cross_amr_only:
            want |= tile_hits[:, 1] > 0
            hits_per_tile = hits_per_tile + tile_hits[:, 1]
        hit_tiles = np.nonzero(want)[0]
        trace["hit_tiles"] += len(hit_tiles)
        if len(hit_tiles) == 0:
            return np.zeros((0, 3), dtype=np.int32)
        total = int(hits_per_tile[hit_tiles].sum())

        dev = words.device
        n_pad = words.shape[0]
        classes = torch.as_tensor(classes, dtype=torch.int32, device=dev)
        if classes.shape[0] < n_pad:
            classes = torch.cat([
                classes,
                torch.full((n_pad - classes.shape[0],), -1,
                           dtype=torch.int32, device=dev),
            ])
        if weights is not None:
            weights = torch.as_tensor(weights, dtype=torch.int8, device=dev)
        window = _window_rows(n_pad, tile, words.shape[1] * 32)
        nwin = n_pad // window
        hti = ti[hit_tiles].astype(np.int64)
        htj = tj[hit_tiles].astype(np.int64)
        group = (hti * tile // window) * nwin + htj * tile // window

    keys, vals = [], []
    a = b = None
    a_win = b_win = None
    for g in np.unique(group):  # window-row major
        w_i, w_j = divmod(int(g), nwin)
        if a_win != w_i:
            # the stationary operand carries the weights, as in the JAX
            # package
            a = None
            with span("extract.unpack"):
                a = unpack_words_to_int8(
                    words[w_i * window : (w_i + 1) * window], weights
                )
            a_win = w_i
        if weights is None and w_j == w_i:
            b, b_win = a, None
        elif b_win != w_j:
            b = None
            with span("extract.unpack"):
                b = unpack_words_to_int8(
                    words[w_j * window : (w_j + 1) * window])
            b_win = w_j
        m = group == g
        # a run of adjacent hit tiles in one tile row is one wider
        # product: the same multiply-adds, far fewer and larger GEMMs
        # when hits are dense
        with span("extract.products"):
            for r_ti, r_tj, r_len in _tile_runs(hti[m], htj[m]):
                i0, j0 = int(r_ti) * tile, int(r_tj) * tile
                width = int(r_len) * tile
                ai, bj = i0 - w_i * window, j0 - w_j * window
                counts = int8_gemm(a[ai : ai + tile], b[bj : bj + width])
                mask = survivor_mask(
                    counts, classes[i0 : i0 + tile],
                    classes[j0 : j0 + width], i0, j0, n=n,
                    threshold=threshold, include_same=not cross_amr_only,
                )
                r, c = torch.nonzero(mask, as_tuple=True)
                keys.append((i0 + r, j0 + c))
                vals.append(counts[r, c])
                trace["extract_products"] += 1
                trace["extract_syncs"] += 1
    del a, b
    with span("extract.fetch"):
        gi = torch.cat([k[0] for k in keys])
        if gi.numel() != total:
            raise AssertionError(
                f"extraction compacted {gi.numel()} pairs, sweep stats "
                f"promised {total}"
            )
        gj = torch.cat([k[1] for k in keys])
        trace["extract_syncs"] += 1
        return _sorted_pairs(gi, gj, torch.cat(vals), n_pad).cpu().numpy()


def _compact_fused(bi, bj, bc, keep, n_pad: int):
    """Compact the fused sweep's candidate buffers ([P, nsub, k], score
    −1 in unused slots), dropping the sub-tiles whose ``keep`` flag is
    False. Returns (pairs int32 [M, 3] sorted by (i, j) on the device,
    M)."""
    m = (bc >= 0) & keep[:, :, None]
    pairs = _sorted_pairs(bi[m], bj[m], bc[m], n_pad)
    return pairs, pairs.shape[0]


def extract_pairs_fused(
    words,
    classes,
    tile_hits: np.ndarray,
    tiles,
    fused: FusedCandidates,
    n: int,
    threshold: int,
    cross_amr_only: bool = True,
    weights=None,
    trace: Optional[dict] = None,
) -> np.ndarray:
    """Fused-mode pair recovery: compact the sweep's own per-sub-tile
    top-k candidates instead of recomputing the hit tiles.

    Exactness never depends on the capacity: the sweep's ``tile_hits``
    are exact, so a sub-tile whose hit count exceeds ``fused.k`` is
    detected, its incomplete candidates dropped, and the tile redone by
    :func:`extract_pairs`. Returns int32 [M, 3] sorted by (i, j).
    ``trace`` is :func:`extract_pairs`'s; the keep mask's bytes count as
    uploaded.
    """
    trace = _new_trace() if trace is None else trace
    ti, tj, tile = tiles
    if tile != fused.block:
        raise ValueError("tile enumeration granularity mismatch")
    if fused.include_same != (not cross_amr_only):
        raise ValueError("the candidates were kept for the other gate")
    n_steps = fused.pairs_ij.shape[0]
    nbs = fused.bs // fused.block
    nsub = nbs * nbs
    n_pad = words.shape[0]
    nb = n_pad // fused.block

    tile_hits = np.asarray(tile_hits)
    h = tile_hits[:, 0].astype(np.int64)
    if not cross_amr_only:
        h = h + tile_hits[:, 1]
    hm = np.zeros((nb, nb), np.int64)
    hm[ti, tj] = h
    s_axis = np.arange(nbs)
    bi_idx = fused.pairs_ij[:, 0:1] // fused.block + s_axis[None, :]
    bj_idx = fused.pairs_ij[:, 1:2] // fused.block + s_axis[None, :]
    # [P, nbs(i), nbs(j)] → [P, nsub]; sub-tiles below the diagonal of a
    # diagonal step are not in the (ti ≤ tj) enumeration: hm is 0 there
    h_ps = hm[bi_idx[:, :, None], bj_idx[:, None, :]].reshape(n_steps, nsub)
    keep = h_ps <= fused.k
    total_kept = int((h_ps * keep).sum())

    trace["hit_tiles"] += int(np.count_nonzero(h))
    parts = []
    if total_kept:
        trace["upload_bytes"] += keep.nbytes
        pairs, count = _compact_fused(
            fused.bi, fused.bj, fused.bc,
            torch.from_numpy(keep).to(fused.bc.device), n_pad,
        )
        if count != total_kept:
            raise AssertionError(
                f"fused compaction found {count} survivors, sweep stats "
                f"promised {total_kept}"
            )
        # each of the three boolean-mask compactions waits for its
        # count, then the fetch
        trace["extract_syncs"] += 4
        parts.append(pairs.cpu().numpy())

    if not keep.all():
        # overflow sub-tiles: redo exactly those by two-pass, with every
        # other tile's hits masked to zero
        op, osub = np.nonzero(~keep)
        rid = np.full((nb, nb), -1, np.int64)
        rid[ti, tj] = np.arange(len(ti))
        rows = rid[bi_idx[op, osub // nbs], bj_idx[op, osub % nbs]]
        masked = np.zeros_like(tile_hits)
        masked[rows] = tile_hits[rows]  # hits > k ≥ 1: rows all ≥ 0
        redo = _new_trace()
        parts.append(
            extract_pairs(
                words, classes, masked, tiles, n=n, threshold=threshold,
                cross_amr_only=cross_amr_only, weights=weights, trace=redo,
            )
        )
        trace["extract_products"] += redo["extract_products"]
        trace["extract_syncs"] += redo["extract_syncs"]

    if not parts:
        return np.zeros((0, 3), dtype=np.int32)
    if len(parts) == 1:
        return parts[0]  # each part arrives sorted by (i, j)
    pairs = np.concatenate(parts, axis=0)
    return pairs[np.lexsort((pairs[:, 1], pairs[:, 0]))]


def _pairwise_native(bitset, classes, config, threshold, index=None,
                     weights=None) -> PairwiseResult:
    """Threaded C++ host sweep through the ``io.native`` runtime:
    the sparse Gustavson sweep when the host index's incidence lists
    exist (it carries the BLOSUM weighting), else the dense popcount
    sweep (unweighted only)."""
    out = None
    if index is not None and index.has_incidences:
        out = native.sparse_sweep(
            index.incidence_protein,
            index.incidence_rank,
            bitset.n,
            index.n_repeated,
            classes,
            threshold,
            include_same=not config.cross_amr_only,
            weights=weights,
        )
    if out is None and weights is not None:
        raise RuntimeError(
            "native weighted sweep unavailable (C++ runtime failed to "
            "load); pick engine='mxu'"
        )
    if out is None:
        out = native.popcount_sweep(
            bitset.words,
            bitset.n,
            classes,
            threshold,
            include_same=not config.cross_amr_only,
        )
    if out is None:
        raise RuntimeError(
            "engine='native' requires the C++ runtime, which failed to "
            "build or load (it needs g++); pick engine='mxu'"
        )
    row_stats, pairs = out
    return PairwiseResult.from_row_stats(
        row_stats, pairs, cross_amr_only=config.cross_amr_only
    )


def _pairwise_stream(bitset, classes, config, threshold, weights, index,
                     device, checkpoint_store, checkpoint_key):
    """``engine="stream"``: the packed matrix stays in HOST memory and row
    blocks stream through the device (``ops/stream.py``), for corpora
    beyond the device's memory. The same int8 products as the MXU engine.
    Returns (row_stats, pairs)."""
    from uniprot_kmer_based_clustering_tpu_torch.ops.stream import (
        CSRBlockSource,
        extract_pairs_stream_auto,
        extract_pairs_stream_fused,
        sweep_extract_stream,
        sweep_mxu_stream,
    )

    n = bitset.n
    common = dict(n=n, threshold=threshold, weights=weights, device=device)
    blocking = dict(bs=config.strip, block=config.tile)
    gate = dict(cross_amr_only=config.cross_amr_only)
    source = None
    if config.stream_source == "csr":
        # blocks materialize on the device from the incidence lists, on
        # the packed matrix's padded geometry, so the tile enumeration is
        # the host-words path's
        if index is None or not getattr(index, "has_incidences", False):
            raise ValueError(
                "stream_source='csr' needs the host-built index "
                "incidence lists (index_engine='host')"
            )
        source = CSRBlockSource(
            index.incidence_protein, index.incidence_rank,
            bitset.n_pad, bitset.w_pad,
        )

    if config.extract == "onepass" or source is not None:
        # statistics and survivors in ONE streamed pass
        row_stats, _, _, pairs = sweep_extract_stream(
            None if source is not None else bitset.words, classes,
            cap=config.extract_k or None, block_source=source,
            checkpoint_store=checkpoint_store,
            checkpoint_key=checkpoint_key, **common, **blocking, **gate,
        )
        return row_stats, pairs

    if config.extract == "fused":
        # the sweep drains survivor candidates inside its in-flight
        # window, so extraction does not re-upload the matrix
        k = config.extract_k or min(512, config.tile * config.tile)
        row_stats, tile_hits, tiles, cands = sweep_mxu_stream(
            bitset.words, classes, fused_k=k,
            fused_same=not config.cross_amr_only, **common, **blocking,
        )
        pairs = extract_pairs_stream_fused(
            bitset.words, classes, tile_hits, tiles, cands, **common, **gate,
        )
        return row_stats, pairs

    row_stats, tile_hits, tiles = sweep_mxu_stream(
        bitset.words, classes, **common, **blocking,
    )
    pairs = extract_pairs_stream_auto(
        bitset.words, classes, tile_hits, tiles, **common, **gate,
    )
    return row_stats, pairs


def pairwise_similarity(
    bitset: BitsetMatrix,
    class_ids: np.ndarray,
    config: Optional[PipelineConfig] = None,
    weights: Optional[np.ndarray] = None,
    index=None,
    checkpoint_store=None,
    checkpoint_key: Optional[str] = None,
    *,
    device,
) -> PairwiseResult:
    """Sweep + exact pair extraction on ``device`` ("cuda", "cpu" or a
    torch.device; CUDA without a GPU raises).

    ``engine="auto"`` resolves to ``mxu`` on CUDA (the JAX package takes
    ``xla`` on a GPU platform); on the CPU to the C++ ``native`` sweep
    when it is built, else to ``mxu`` on the plain versions.
    ``popcount`` and ``xla`` both run the popcount formulation: K4 on
    CUDA, the plain sweep on the CPU, at ``config.tile``. ``weights``
    (int8 per bit column) switch to the BLOSUM-weighted score, which the
    MXU and stream engines carry as a column scale and the native engine
    only through its sparse sweep; every other engine gives way to
    ``mxu``. ``extract="fused"`` makes the MXU scan sweep keep its
    survivors (capacity ``config.extract_k``, 0 = auto); on the strip
    schedule and the popcount engines it is two-pass, as in the JAX
    package. ``engine="stream"`` keeps the matrix on the host
    (:func:`_pairwise_stream`); ``extract="onepass"`` is its mode alone
    and raises ``ValueError`` on any other engine.
    ``checkpoint_store``/``checkpoint_key`` turn on the one-pass stream
    sweep's group-boundary checkpoints.
    """
    config = config or PipelineConfig()
    device = resolve_device(device)
    n, n_pad = bitset.n, bitset.n_pad
    classes_np = np.full(n_pad, -1, dtype=np.int32)
    classes_np[:n] = np.asarray(class_ids, dtype=np.int32)

    engine = config.engine
    if engine == "auto":
        engine = "mxu"
        if device.type == "cpu":
            if native.available():
                engine = "native"
    if weights is not None and engine == "native":
        if not (index is not None and index.has_incidences
                and native.available()):
            engine = "mxu"
    elif weights is not None and engine != "stream":
        # the popcount engines count unweighted bits; the stream engine
        # multiplies too and carries the weights itself
        engine = "mxu"

    threshold = (
        config.effective_weighted_threshold(weights)
        if weights is not None
        else config.threshold
    )
    if config.extract == "onepass" and engine != "stream":
        raise ValueError(
            "extract='onepass' is a stream-engine mode (the one-pass "
            f"out-of-core sweep); resolved engine is {engine!r}"
        )
    if engine == "native":
        return _pairwise_native(
            bitset, classes_np, config, threshold, index=index,
            weights=weights,
        )
    if engine == "stream":
        row_stats, pairs = _pairwise_stream(
            bitset, classes_np, config, threshold, weights, index, device,
            checkpoint_store, checkpoint_key,
        )
        return PairwiseResult.from_row_stats(
            row_stats, pairs, cross_amr_only=config.cross_amr_only
        )

    trace = _new_trace()
    with span("pairwise.upload"):
        words = bitset_to_torch(bitset, device)
        classes = classes_to_torch(classes_np, n_pad, device)
        wts = None if weights is None else weights_to_torch(weights, device)
    trace["upload_bytes"] = sum(t.nbytes for t in (words, classes, wts)
                                if t is not None)
    fused = None
    with span("pairwise.sweep"):
        if engine == "mxu":
            strip = config.strip
            if strip is not None and n_pad % strip != 0:
                strip = config.tile
            want_fused = config.extract == "fused"
            out = sweep_mxu(
                words, classes, n=n, threshold=threshold, strip=strip,
                block=config.tile, weights=wts,
                fused_k=(config.extract_k or None) if want_fused else 0,
                fused_same=not config.cross_amr_only,
            )
            row_stats, tile_hits, tiles = out[:3]
            if want_fused:
                fused = out[3]
        else:
            row_stats, tile_hits, tiles = sweep(
                words, classes, n=n, threshold=config.threshold,
                tile=config.tile,
            )
    with span("pairwise.extract"):
        if fused is not None:
            pairs = extract_pairs_fused(
                words, classes, tile_hits, tiles, fused, n=n,
                threshold=threshold, cross_amr_only=config.cross_amr_only,
                weights=wts, trace=trace,
            )
        else:
            pairs = extract_pairs(
                words, classes, tile_hits, tiles, n=n, threshold=threshold,
                cross_amr_only=config.cross_amr_only, weights=wts,
                trace=trace,
            )
    trace["pairs"] = len(pairs)
    global last_trace
    last_trace = trace
    with span("pairwise.result"):
        return PairwiseResult.from_row_stats(
            row_stats, pairs, cross_amr_only=config.cross_amr_only
        )
