"""Single-device pairwise similarity: sweep statistics + exact pair list.

Counterpart of the JAX package's ``similarity/pairwise.py`` for the
engines the port has so far (``auto``, ``mxu``, ``native``). Two-pass
extraction: pass 1 is the sweep, which reports exact per-tile hit
counts; pass 2 recomputes only the hit tiles (a run of adjacent hit
tiles in one tile row as one product), compacts the survivors with
``torch.nonzero``, sorts them on the device by ``i·N_pad + j`` and
copies the pair list to the host once. The TPU compaction workarounds
(superblock coalescing, top_k selection) are not carried over: they
exist because scatter serializes on a TPU (ROADMAP queue 1, item 3).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from uniprot_kmer_based_clustering_tpu.config import PipelineConfig
from uniprot_kmer_based_clustering_tpu.kmers.bitset import BitsetMatrix
from uniprot_kmer_based_clustering_tpu_torch.device import resolve_device
from uniprot_kmer_based_clustering_tpu_torch.ops.bitmul import (
    int8_gemm,
    sweep_mxu,
    unpack_words_to_int8,
)
from uniprot_kmer_based_clustering_tpu_torch.state import (
    bitset_to_torch,
    classes_to_torch,
    weights_to_torch,
)


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


def _tile_runs(ti: np.ndarray, tj: np.ndarray):
    """Runs of column-adjacent tiles within one tile row, from a
    row-major tile list: (ti, first tj, run length) each."""
    new = np.ones(len(ti), dtype=bool)
    new[1:] = (ti[1:] != ti[:-1]) | (tj[1:] != tj[:-1] + 1)
    starts = np.nonzero(new)[0]
    lengths = np.diff(np.append(starts, len(ti)))
    return zip(ti[starts], tj[starts], lengths)


def extract_pairs(
    words,
    classes,
    tile_hits: np.ndarray,
    tiles,
    n: int,
    threshold: int,
    cross_amr_only: bool = True,
    weights=None,
) -> np.ndarray:
    """Pass-2 exact pair recovery from the tiles that reported hits.

    ``words`` int32 [N_pad, W] and ``classes`` (int32, padded to N_pad
    with −1 or length n) on the sweep's device; ``tiles`` is the
    (ti, tj, tile) enumeration the sweep returned with ``tile_hits``.
    With ``weights`` (int8 [W*32]) the recovered values are the weighted
    scores. Returns int32 [M, 3] (i, j, count) sorted by (i, j); raises
    when the compacted count disagrees with the sweep's promise.
    """
    ti, tj, tile = tiles
    tile_hits = np.asarray(tile_hits)
    want = tile_hits[:, 0] > 0
    hits_per_tile = tile_hits[:, 0].astype(np.int64)
    if not cross_amr_only:
        want |= tile_hits[:, 1] > 0
        hits_per_tile = hits_per_tile + tile_hits[:, 1]
    hit_tiles = np.nonzero(want)[0]
    if len(hit_tiles) == 0:
        return np.zeros((0, 3), dtype=np.int32)
    total = int(hits_per_tile[hit_tiles].sum())

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
    # the stationary operand carries the weights, as in the JAX package
    bits_a = unpack_words_to_int8(words, weights)
    bits_b = bits_a if weights is None else unpack_words_to_int8(words)

    # a run of adjacent hit tiles in one tile row is one wider product:
    # the same multiply-adds, far fewer and larger GEMMs when hits are dense
    keys, vals = [], []
    for r_ti, r_tj, r_len in _tile_runs(ti[hit_tiles], tj[hit_tiles]):
        i0, j0, width = int(r_ti) * tile, int(r_tj) * tile, int(r_len) * tile
        counts = int8_gemm(bits_a[i0 : i0 + tile], bits_b[j0 : j0 + width])
        gi = torch.arange(i0, i0 + tile, device=dev)[:, None]
        gj = torch.arange(j0, j0 + width, device=dev)[None, :]
        mask = (counts > threshold) & (gi < gj) & (gj < n)
        if cross_amr_only:
            ca, cb = classes[i0 : i0 + tile], classes[j0 : j0 + width]
            mask &= ca[:, None] != cb[None, :]
        r, c = torch.nonzero(mask, as_tuple=True)
        keys.append((i0 + r) * n_pad + (j0 + c))
        vals.append(counts[r, c])
    del bits_a, bits_b
    key = torch.cat(keys)
    val = torch.cat(vals)
    if key.numel() != total:
        raise AssertionError(
            f"extraction compacted {key.numel()} pairs, sweep stats "
            f"promised {total}"
        )
    key, order = torch.sort(key)
    pairs = torch.stack(
        [key // n_pad, key % n_pad, val[order].to(torch.int64)], dim=1
    ).to(torch.int32)
    return pairs.cpu().numpy()


def _pairwise_native(bitset, classes, config, threshold, index=None,
                     weights=None) -> PairwiseResult:
    """Threaded C++ host sweep through the shared ``io.native`` runtime:
    the sparse Gustavson sweep when the host index's incidence lists
    exist (it carries the BLOSUM weighting), else the dense popcount
    sweep (unweighted only)."""
    from uniprot_kmer_based_clustering_tpu.io import native

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
            "engine='native' requires the C++ runtime; build it with "
            "`make -C native` or pick engine='mxu'"
        )
    row_stats, pairs = out
    return PairwiseResult.from_row_stats(
        row_stats, pairs, cross_amr_only=config.cross_amr_only
    )


_NOT_PORTED = {
    "popcount": "the popcount engines (ROADMAP queue 1, item 6)",
    "xla": "the popcount engines (ROADMAP queue 1, item 6)",
    "stream": "the out-of-core stream engine (ROADMAP queue 1, item 9)",
}


def check_supported(config: PipelineConfig) -> None:
    """Raise for the configuration knobs the port does not carry yet."""
    if config.engine in _NOT_PORTED:
        raise NotImplementedError(
            f"engine={config.engine!r} needs {_NOT_PORTED[config.engine]}, "
            "not yet ported; use auto, mxu or native"
        )
    if config.extract == "fused":
        raise NotImplementedError(
            "extract='fused' needs the scan-schedule sweep, not yet "
            "ported (ROADMAP queue 1, item 8)"
        )
    if config.extract == "onepass":
        raise NotImplementedError(
            "extract='onepass' is a stream-engine mode, not yet ported "
            "(ROADMAP queue 1, item 9)"
        )
    if config.index_engine != "host":
        raise NotImplementedError(
            "index_engine='device' is not yet ported (ROADMAP queue 1, "
            "item 11)"
        )


def pairwise_similarity(
    bitset: BitsetMatrix,
    class_ids: np.ndarray,
    config: Optional[PipelineConfig] = None,
    weights: Optional[np.ndarray] = None,
    index=None,
    *,
    device,
) -> PairwiseResult:
    """Sweep + two-pass extraction on ``device`` ("cuda", "cpu" or a
    torch.device; CUDA without a GPU raises).

    ``engine="auto"`` resolves to ``mxu`` on CUDA; on the CPU to the C++
    ``native`` sweep when it is built, else to ``mxu`` on the plain
    versions. ``weights`` (int8 per bit column) switch to the
    BLOSUM-weighted score, which the MXU engine carries as a column
    scale and the native engine only through its sparse sweep.
    """
    config = config or PipelineConfig()
    check_supported(config)
    device = resolve_device(device)
    n, n_pad = bitset.n, bitset.n_pad
    classes_np = np.full(n_pad, -1, dtype=np.int32)
    classes_np[:n] = np.asarray(class_ids, dtype=np.int32)

    engine = config.engine
    if engine == "auto":
        engine = "mxu"
        if device.type == "cpu":
            from uniprot_kmer_based_clustering_tpu.io import native

            if native.available():
                engine = "native"
    if weights is not None and engine == "native":
        from uniprot_kmer_based_clustering_tpu.io import native

        if not (index is not None and index.has_incidences
                and native.available()):
            engine = "mxu"

    threshold = (
        config.effective_weighted_threshold(weights)
        if weights is not None
        else config.threshold
    )
    if engine == "native":
        return _pairwise_native(
            bitset, classes_np, config, threshold, index=index,
            weights=weights,
        )

    words = bitset_to_torch(bitset, device)
    classes = classes_to_torch(classes_np, n_pad, device)
    wts = None if weights is None else weights_to_torch(weights, device)
    strip = config.strip
    if strip is not None and n_pad % strip != 0:
        strip = config.tile
    row_stats, tile_hits, tiles = sweep_mxu(
        words, classes, n=n, threshold=threshold, strip=strip,
        block=config.tile, weights=wts,
    )
    pairs = extract_pairs(
        words, classes, tile_hits, tiles, n=n, threshold=threshold,
        cross_amr_only=config.cross_amr_only, weights=wts,
    )
    return PairwiseResult.from_row_stats(
        row_stats, pairs, cross_amr_only=config.cross_amr_only
    )
