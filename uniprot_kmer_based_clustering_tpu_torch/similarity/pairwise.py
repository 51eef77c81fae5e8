"""Single-device pairwise similarity: sweep statistics + exact pair list.

Counterpart of the JAX package's ``similarity/pairwise.py`` for the
engines ``auto``, ``mxu``, ``popcount``, ``xla``, ``native`` and
``stream``. Every route ends in the device pair list of
``ops/pairlist.py`` or, for the fused scan, in its (i, j) sort.

- Extraction from the epilogue (:func:`extract_pairs` with
  ``appended``; ``extract`` ``auto`` or ``fused`` on the strip
  schedule): the sweep's K1 epilogue appended every survivor to device
  pair buffers (``EPILOGUE_PAIR_CAP`` slots) as it read the counts;
  extraction checks their cursor against the sweep's exact tile hits,
  then sorts and fetches them once. Survivors beyond the capacity take
  pass 2 below instead.
- Two-pass extraction (:func:`extract_pairs`; ``extract="two_pass"``,
  the scan schedule's ``auto`` and the popcount engines): pass 1 is the
  sweep, which reports exact per-tile hit counts; pass 2 recomputes only
  the hit tiles (a run of adjacent hit tiles in one tile row as one
  product), appends each product's survivors to pair buffers behind a
  cursor that stays on the device, and ends in the same fetch.
- Fused extraction (:func:`extract_pairs_fused`, ``extract="fused"`` on
  the scan schedule): the sweep kept each sub-tile's survivors; they are
  compacted and sorted on the device, and the sub-tiles whose exact hit
  count exceeded the capacity are redone by two-pass.
- ``engine="stream"`` (``ops/stream.py``) keeps the packed matrix on the
  host and streams row blocks through the device, appending to the same
  pair list.

The TPU compaction workarounds of the in-core path (superblock
coalescing, top_k selection in pass 2) are not carried over.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from uniprot_kmer_based_clustering_tpu_torch.config import PipelineConfig
from uniprot_kmer_based_clustering_tpu_torch.device import resolve_device
from uniprot_kmer_based_clustering_tpu_torch.io import native
from uniprot_kmer_based_clustering_tpu_torch.kmers.bitset import (
    BitsetMatrix,
    DeviceBitsetMatrix,
    pinned_of,
)
from uniprot_kmer_based_clustering_tpu_torch.ops.bitmul import (
    FusedCandidates,
    int8_gemm,
    survivor_mask,
    sweep_mxu,
    unpack_words_to_int8,
)
from uniprot_kmer_based_clustering_tpu_torch.ops.pairlist import (
    append_rows,
    append_window,
    check_cursor,
    merge_pairs,
    new_pair_buffers,
    tile_survivors,
    vcap_bucket,
)
from uniprot_kmer_based_clustering_tpu_torch.ops.pairlist import (
    sorted_pairs as _sorted_pairs,
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
#: classes, weights and the fused keep mask copied to the device; not
#: the words of a bitset built there), ``pinned_bytes`` (those of
#: ``upload_bytes`` sent from page-locked host memory as asynchronous
#: DMAs: on a CUDA device the classes and weights always, the words when
#: they were packed page-locked; 0 on the CPU), ``hit_tiles``,
#: ``extract_products`` (pass-2 ``int8_gemm`` calls, one a run of
#: adjacent hit tiles), ``extract_syncs`` (every host wait of
#: extraction: a boolean-mask compaction of the fused scan, and the
#: fetch), ``epilogue_pairs`` (the survivors K1 appended, 0 off
#: the epilogue route) and ``pairs``. Times are the spans'
#: (``utils.timing``).
last_trace: dict = {}


def _new_trace() -> dict:
    return dict(upload_bytes=0, pinned_bytes=0, hit_tiles=0,
                extract_products=0, extract_syncs=0, epilogue_pairs=0,
                pairs=0)


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


def _fetch(buffers, total: int) -> np.ndarray:
    """The in-core fetch: the cursor check, then the (i, j) sort of the
    first ``total`` slots on the device and one copy to the host."""
    bi, bj, bc, cursor = buffers
    check_cursor(cursor, total)
    return _sorted_pairs(bi[:total], bj[:total], bc[:total]).cpu().numpy()


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


def _pass2_plan(words, classes, weights, hti, htj, tile: int):
    """Pass 2's operands and schedule: the classes padded to N_pad with
    −1 and the weights on the words' device, the unpack window's rows
    and the windows a side, the hit tiles' (ti, tj) and the window pair
    each falls in (window-row major)."""
    dev = words.device
    n_pad = words.shape[0]
    classes = torch.as_tensor(classes, dtype=torch.int32, device=dev)
    if classes.shape[0] < n_pad:
        classes = torch.cat([
            classes,
            torch.full((n_pad - classes.shape[0],), -1, dtype=torch.int32,
                       device=dev),
        ])
    if weights is not None:
        weights = torch.as_tensor(weights, dtype=torch.int8, device=dev)
    window = _window_rows(n_pad, tile, words.shape[1] * 32)
    nwin = n_pad // window
    hti, htj = hti.astype(np.int64), htj.astype(np.int64)
    group = (hti * tile // window) * nwin + htj * tile // window
    return classes, weights, window, nwin, hti, htj, group


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
    appended=None,
) -> np.ndarray:
    """Exact pair recovery from the tiles that reported hits.

    ``words`` int32 [N_pad, W] and ``classes`` (int32, padded to N_pad
    with −1 or length n) on the sweep's device; ``tiles`` is the
    (ti, tj, tile) enumeration the sweep returned with ``tile_hits``.
    With ``appended`` (``sweep_mxu(..., append=True).pairs``: (bi, bj,
    bc, cursor), the cursor on the host) the survivors the
    sweep's K1 appended are sorted and fetched once when they fit the
    buffers, and nothing is recomputed; the cursor counts every survivor,
    so more than the buffers hold shows, and pass 2 runs instead.
    Pass 2 recomputes the hit tiles and appends each product's survivors
    to fresh pair buffers (``ops.pairlist.append_rows``), with no host
    wait before the fetch: with ``weights`` (int8 [W*32]) the
    recovered values are the weighted scores; the bit matrix is unpacked
    in row windows of at most ``_UNPACK_WINDOW_BYTES`` (the whole matrix
    when it fits: 2.6 GB for the 10,619-protein corpus). Returns int32
    [M, 3] (i, j, count) sorted by (i, j); raises when the compacted
    count disagrees with the sweep's promise. ``trace`` (a
    :data:`last_trace` dict) gains the hit tiles, the survivors K1
    appended, the products and the host syncs.
    """
    trace = _new_trace() if trace is None else trace
    with span("extract.plan"):
        ti, tj, tile = tiles
        hits = tile_survivors(tile_hits, cross_amr_only)
        hit_tiles = np.nonzero(hits)[0]
        total = int(hits.sum())
        trace["hit_tiles"] += len(hit_tiles)
        found = 0 if appended is None else int(appended[3])
        trace["epilogue_pairs"] += found
        fetch = appended is not None and found <= appended[0].numel()
        if not total and not (fetch and found):
            return np.zeros((0, 3), dtype=np.int32)
        if not fetch:
            classes, weights, window, nwin, hti, htj, group = _pass2_plan(
                words, classes, weights, ti[hit_tiles], tj[hit_tiles], tile)
            # a product is at most N_pad columns wide
            buffers = new_pair_buffers(
                vcap_bucket(total) + append_window(words.shape[0]),
                words.device)
    if fetch:
        with span("extract.fetch"):
            trace["extract_syncs"] += 1
            return _fetch(appended, total)

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
                buffers = append_rows(*buffers, mask, counts, i0, j0)
                trace["extract_products"] += 1
    del a, b
    with span("extract.fetch"):
        trace["extract_syncs"] += 1
        return _fetch(buffers, total)


def _compact_fused(bi, bj, bc, keep):
    """Compact the fused sweep's candidate buffers ([P, nsub, k], score
    −1 in unused slots), dropping the sub-tiles whose ``keep`` flag is
    False. Returns (pairs int32 [M, 3] sorted by (i, j) on the device,
    M)."""
    m = (bc >= 0) & keep[:, :, None]
    pairs = _sorted_pairs(bi[m], bj[m], bc[m])
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
    h = tile_survivors(tile_hits, cross_amr_only)
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
            torch.from_numpy(keep).to(fused.bc.device),
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
    return merge_pairs(*parts)


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
    survivors (capacity ``config.extract_k``, 0 = auto). On the strip
    schedule ``auto`` and ``fused`` take the survivors K1 appended;
    ``two_pass``, the scan's ``auto`` and the popcount engines recompute
    the hit tiles (:func:`extract_pairs`). ``engine="stream"`` keeps the
    matrix on the host (:func:`_pairwise_stream`); ``extract="onepass"``
    is its mode alone and raises ``ValueError`` on any other engine.
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
    # a bitset built on the device hands over its own words: no copy
    held = (bitset.device_words if isinstance(bitset, DeviceBitsetMatrix)
            else None)
    sent = [t for t in (words, classes, wts)
            if t is not None and t is not held]
    trace["upload_bytes"] = sum(t.nbytes for t in sent)
    if device.type == "cuda":
        trace["pinned_bytes"] = sum(
            t.nbytes for t in sent
            if t is not words or pinned_of(bitset) is not None)
    fused = appended = None
    with span("pairwise.sweep"):
        if engine == "mxu":
            strip = config.strip
            if strip is not None and n_pad % strip != 0:
                strip = config.tile
            want_fused = config.extract == "fused"
            # K1 hands over its survivors on the strip schedule
            want_appended = config.extract in ("auto", "fused")
            out = sweep_mxu(
                words, classes, n=n, threshold=threshold, strip=strip,
                block=config.tile, weights=wts,
                fused_k=(config.extract_k or None) if want_fused else 0,
                fused_same=not config.cross_amr_only, append=want_appended,
            )
            row_stats, tile_hits, tiles = out[:3]
            if want_appended:
                fused, appended = out.fused, out.pairs
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
                trace=trace, appended=appended,
            )
    trace["pairs"] = len(pairs)
    global last_trace
    last_trace = trace
    with span("pairwise.result"):
        return PairwiseResult.from_row_stats(
            row_stats, pairs, cross_amr_only=config.cross_amr_only
        )
