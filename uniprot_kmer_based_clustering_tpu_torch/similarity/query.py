"""Query serving: shared-k-mer search of new sequences against a built
corpus index, on one torch device.

Counterpart of the JAX package's ``similarity/query.py``. The packed
corpus bitset is a standing index: encoding Q query sequences,
rank-hashing them into the corpus's repeated-k-mer space, and a blocked
[N, K]·[K, Q] int8 product give every query's shared-k-mer counts against
all N corpus proteins (k-mers outside the corpus's repeated set do not
match on those positions, exactly as a corpus member's would not).

Serving loops hold a :class:`QueryServer`. On a CUDA device it keeps the
packed corpus resident (uploaded once, laid out as 128-word chunks), and
each batch runs the contraction chunk by chunk: every chunk of the corpus
and of the query rows is unpacked to int8 (``ops.bitmul.
unpack_words_to_int8``) and multiplied by ``torch._int_mm``, so the device
holds the packed corpus, one unpacked 4,096-column chunk and the counts,
never the full unpack (8× the packed bitset). Query counts pad to
power-of-two buckets (min 8), and a batch finishes with a
threshold/top-k epilogue on the device whose lanes one fetch brings back;
a query with more hits than the candidate capacity is re-answered exactly
through the full counts. On the CPU the server instead walks a rank-CSR
of the corpus incidence lists (the Gustavson structure of the native
sweep), with bit-identical results. On a mesh (``mesh=``) the corpus rows
are sharded over every shard, each shard answers its rows from its own
chunks, and the count slices are gathered to the first shard.

``torch._int_mm`` on CUDA needs more than 16 rows in its first operand and
multiples of 8 in the contraction and in its second operand's rows. The
corpus rows go first (a block of fewer than 24 rows is padded to 24), and
the query rows second (every bucket is a power of two ≥ 8), so every
bucket and block size is legal.
"""

from __future__ import annotations

import warnings
from typing import List, Optional, Sequence

import numpy as np
import torch

from uniprot_kmer_based_clustering_tpu_torch.device import resolve_device
from uniprot_kmer_based_clustering_tpu_torch.kmers.bitset import BitsetMatrix
from uniprot_kmer_based_clustering_tpu_torch.kmers.encode import (
    encode_kmers,
    seqs_to_buffer,
)
from uniprot_kmer_based_clustering_tpu_torch.kmers.index import KmerIndex
from uniprot_kmer_based_clustering_tpu_torch.ops.bitmul import (
    int8_gemm,
    unpack_words_to_int8,
)
from uniprot_kmer_based_clustering_tpu_torch.parallel.mesh import (
    broadcast_from_first,
    gather_to_first,
)

_BLOCK_WORDS = 128  # 4096 bit columns unpacked per contraction step
_INT32_MIN = -(2**31)
# the first _int_mm operand is padded to at least this many rows (CUDA
# needs more than 16)
_MIN_MM_ROWS = 24


def query_ranks(
    index: KmerIndex, seqs: Sequence[str]
) -> List[np.ndarray]:
    """Per-query deduplicated rank-hash ids: encode each sequence's
    k-mers and map them into the corpus's repeated-k-mer rank space
    (non-repeated/unknown k-mers drop out). The single definition of
    "which corpus bit columns does this query touch" — every serving
    path builds on it, so they cannot drift."""
    buf, offsets = seqs_to_buffer(seqs)
    codes, koff = encode_kmers(buf, offsets, index.k)
    out = []
    for qi in range(len(seqs)):
        ranks = index.rank_of(codes[koff[qi] : koff[qi + 1]])
        out.append(np.unique(ranks[ranks >= 0]).astype(np.int64))
    return out


def pack_query_bitsets(
    index: KmerIndex, seqs: Sequence[str], w_pad: int
) -> np.ndarray:
    """uint32 [Q, w_pad] presence rows for query sequences, in the
    corpus's rank-hash bit space (non-repeated k-mers drop out)."""
    words = np.zeros((len(seqs), w_pad), np.uint32)
    for qi, ranks in enumerate(query_ranks(index, seqs)):
        np.bitwise_or.at(
            words[qi], ranks >> 5, np.uint32(1) << (ranks & 31).astype(np.uint32)
        )
    return words


def _bucket(n: int) -> int:
    """The power-of-two row bucket (min 8) a batch of n queries pads to."""
    return max(8, 1 << (n - 1).bit_length())


def _word_chunks(rows):
    """The 128-word column chunks [R, 128] of packed rows [R, W]."""
    return [rows[:, k0 : k0 + _BLOCK_WORDS]
            for k0 in range(0, rows.shape[1], _BLOCK_WORDS)]


def _chunk_product(corpus_words, query_bits, weights):
    """int32 [R, Q] partial counts of one chunk: the corpus rows
    [R, 128] unpacked (and scaled by ``weights`` int8 [4096] when given)
    times the unpacked query chunk [Q, 4096]. A first operand of fewer
    than 24 rows is padded with empty rows to 24 (``_int_mm`` on CUDA
    needs more than 16)."""
    r = corpus_words.shape[0]
    if r < _MIN_MM_ROWS:
        corpus_words = torch.nn.functional.pad(
            corpus_words, (0, 0, 0, _MIN_MM_ROWS - r))
    a = unpack_words_to_int8(corpus_words, weights)
    return int8_gemm(a, query_bits)[:r]


def _upload_chunks(words: np.ndarray, device):
    """Packed rows int32 [R, W] as ``[W/128, R, 128]`` chunks on
    ``device``, copied up one chunk at a time."""
    blocks = torch.empty((words.shape[1] // _BLOCK_WORDS, words.shape[0],
                          _BLOCK_WORDS), dtype=torch.int32, device=device)
    for b, chunk in enumerate(_word_chunks(words)):
        blocks[b].copy_(torch.from_numpy(chunk))
    return blocks


def blocked_counts(qwords, corpus_chunks, weights=None):
    """int32 [R, Q] shared counts of the query rows ``qwords`` int32
    [Q, W] against the corpus rows given as W/128 chunks [R, 128], summed
    in place over the chunks. ``weights`` (int8 [W*32] or None) scale the
    corpus columns, as the weighted sweep scales its moving operand."""
    acc = None
    for b, chunk in enumerate(corpus_chunks):
        k0 = b * _BLOCK_WORDS
        qb = unpack_words_to_int8(qwords[:, k0 : k0 + _BLOCK_WORDS])
        wb = (None if weights is None
              else weights[k0 * 32 : (k0 + _BLOCK_WORDS) * 32])
        part = _chunk_product(chunk, qb, wb)
        acc = part if acc is None else acc.add_(part)
    return acc


def canonical_lane_sort(vals, idx):
    """Top-k lanes in the serving order contract: count descending, index
    ascending. ``torch.topk`` does not specify its tie order, so the
    lanes are sorted on one int64 key, ``~vals`` in the high word and the
    (non-negative) index in the low word. Bitwise NOT is a total,
    overflow-safe descending map: the INT32_MIN sentinel maps to
    INT32_MAX and its lanes sort last, where plain negation would
    overflow."""
    key = ((torch.bitwise_not(vals).to(torch.int64) << 32)
           | idx.to(torch.int64))
    key = torch.sort(key, dim=1).values
    return (torch.bitwise_not((key >> 32).to(torch.int32)),
            (key & 0xFFFFFFFF).to(torch.int32))


def topk_epilogue(counts_rq, threshold: int, n_valid: int, cap: int):
    """Threshold/top-k epilogue of one batch's counts ``counts_rq`` int32
    [R, Q] (corpus-major): int32 [Q, 2·cap+1] = the best ``cap``
    (value | index) lanes of each query in the canonical order, then its
    EXACT hit count. A hit is ``count > threshold`` in a column below
    ``n_valid`` (padding rows are all-zero words, count 0, but a negative
    threshold would admit them). Non-hit lanes carry INT32_MIN: counts
    are int32 sums of int8 products (|count| ≤ 127·K ≪ 2³¹), so every real
    hit, negative-weighted ones under a threshold below −1 included,
    ranks above them. The selection is exact whenever the hit count is ≤
    ``cap``; the caller redoes a query whose count exceeds it."""
    counts = counts_rq.t().contiguous()
    cols = torch.arange(counts.shape[1], device=counts.device)
    hit = (counts > threshold) & (cols < n_valid)
    nhits = hit.sum(dim=1, dtype=torch.int32)
    masked = torch.where(hit, counts, _INT32_MIN)
    vals, idx = torch.topk(masked, cap, dim=1)
    vals, idx = canonical_lane_sort(vals, idx)
    return torch.cat([vals, idx, nhits[:, None]], dim=1)


def _sorted_matches(hits, counts):
    """int64 [M, 2] (index, count) rows in count-desc, index-asc order."""
    c = counts.astype(np.int64)
    order = np.lexsort((hits, -c))
    return np.stack([hits[order].astype(np.int64), c[order]], axis=1)


class QueryServer:
    """A standing corpus index for repeated shared-k-mer queries on one
    torch ``device`` (``"cuda"`` raises when no GPU is visible).

    Three serving modes, identical outputs (pinned in tests against the
    JAX package's):
      * device: uploads the packed corpus once, in 128-word chunks, and
        answers with chunked int8 products and the top-k epilogue;
      * host (``mode="auto"`` on a CPU server whose index carries the
        host-built incidence lists): a rank-CSR walk, no device at all;
      * stream (``mode="stream"``): the corpus bitset stays in HOST
        memory and row blocks of ``stream_bs`` rows go through the device
        per batch — from the host matrix through the stream engine's
        pinned ring and copy stream (``stream_source="host"``), or rebuilt
        on the device from the incidence lists uploaded once
        (``"csr"``; ``"auto"`` takes it when the incidences exist).
        Each batch re-moves the whole corpus from the host on the host
        source, so batch large and prefer device mode where the bitset
        fits.

    ``weights`` (int8 [w_pad*32], utils.blosum.rank_weights_int8)
    switches scores to BLOSUM-weighted mode, as in the weighted sweep.

    ``mesh`` (``parallel.make_mesh``/``make_mesh_2d``: rows are sharded
    over every axis, so a 2 × 4 mesh splits 8 ways) makes a device server
    whose N_pad corpus rows divide evenly over the shards: each shard
    keeps its rows as 128-word chunks on its device, every batch's query
    rows go to each shard, and the shards' ``[rows_k, Q]`` count slices
    are gathered to the first shard, where the full counts are read (no
    top-k epilogue, as in the JAX package). The latency route is off on a
    mesh unless ``host_route_max`` is a number; ``mode="host"`` and
    ``mode="stream"`` raise; a mesh that spans several processes raises, as
    the JAX package cannot serve over one either (its mesh server reads
    counts spread over devices another process holds). ``device`` may name the mesh's first device
    but not contradict it.
    """

    def __init__(
        self,
        index: KmerIndex,
        bitset: BitsetMatrix,
        weights: Optional[np.ndarray] = None,
        mode: str = "auto",
        mesh=None,
        topk_cap: int = 512,
        stream_bs: Optional[int] = None,
        stream_source: str = "auto",
        host_route_max: object = "auto",
        device=None,
    ):
        if mode not in ("auto", "host", "device", "stream"):
            raise ValueError(f"unknown mode {mode!r}")
        self._mesh = mesh
        if mesh is None:
            self.device = resolve_device("cuda" if device is None else device)
        else:
            if mesh.multiprocess:
                raise ValueError(
                    "QueryServer on a mesh that spans several processes: "
                    "the JAX package does not serve over a mesh of several "
                    "processes either (its mesh server reads the counts of "
                    "devices other processes hold); build the server on "
                    "one process's mesh"
                )
            if device is not None and resolve_device(device) != mesh.devices[0]:
                raise ValueError(
                    f"device {device!r} is not the mesh's first device "
                    f"{mesh.devices[0]}"
                )
            self.device = mesh.devices[0]
        self.index = index
        self.bitset = bitset
        self.weighted = weights is not None
        self._weights = weights
        self._wts = None
        if self.weighted and mode != "host":
            self._wts = torch.from_numpy(
                np.ascontiguousarray(weights, dtype=np.int8)
            ).to(self.device)
        # LATENCY routing: a batch of ≤ host_route_max queries answers
        # through the host rank-CSR walk even on device/stream/mesh
        # servers (the CSR is built on first use). "auto" enables the
        # route (break-even batch 4, the JAX package's) for mode="auto"
        # servers without a mesh only — an EXPLICIT mode="device"/"stream"
        # or mesh server keeps its kernel on every batch; a number forces
        # the route on any non-host server, 0 disables it.
        self._host_route_max = 0
        if index.has_incidences and mode != "host":
            if host_route_max == "auto":
                self._host_route_max = (
                    4 if (mode == "auto" and mesh is None) else 0
                )
            else:
                self._host_route_max = int(host_route_max)
        self._host_csr_built = False
        # a query with more hits than topk_cap is re-answered exactly
        # through the full counts (only the overflowed rows); ≤ 0 disables
        # the epilogue
        self._topk_cap = int(topk_cap)
        # set when an add_proteins rollback fails and the serving state
        # (CSR / device chunks) no longer matches index/bitset; queries
        # raise until rebuild_serving() succeeds
        self._needs_rebuild = False
        self._blocks = None
        self._stream_mode = mode == "stream"
        if self._stream_mode:
            if mesh is not None:
                raise ValueError(
                    "mode='stream' is single-device (shard a mesh with "
                    "mesh=... instead)"
                )
            self._host_mode = False
            # rows per streamed block: ~1.5 GB of packed words by default
            # (word-chunked, so only the packed block plus one unpack chunk
            # is ever device-resident)
            if stream_bs is None:
                stream_bs = max(
                    1024,
                    min(
                        bitset.n_pad,
                        ((3 << 29) // (bitset.w_pad * 4)) // 1024 * 1024,
                    ),
                )
            self._stream_bs = int(stream_bs)
            if stream_source not in ("auto", "host", "csr"):
                raise ValueError(
                    f"unknown stream_source {stream_source!r}"
                )
            use_csr = stream_source == "csr" or (
                stream_source == "auto" and index.has_incidences
            )
            if use_csr and not index.has_incidences:
                raise ValueError(
                    "stream_source='csr' needs the host-built index "
                    "incidence lists"
                )
            self._use_csr = use_csr
            #: upload seconds, uploads and bytes uploaded by the stream
            #: block feed since the server was built
            self.stream_trace = {}
            self._build_stream_source()
            return
        if mesh is not None:
            if mode == "host":
                raise ValueError("mode='host' is single-process")
            self._host_mode = False
            self._build_device_blocks()
            return
        if mode == "auto":
            self._host_mode = (
                self.device.type == "cpu" and index.has_incidences
            )
        else:
            self._host_mode = mode == "host"
            if self._host_mode and not index.has_incidences:
                raise ValueError(
                    "mode='host' needs the host-built incidence lists"
                )
        if self._host_mode:
            self._build_host_csr()
        else:
            self._build_device_blocks()

    def set_host_route_max(self, n: int) -> None:
        """Adjust the latency-route break-even batch at runtime
        (0 disables routing); needs the host-built incidence lists.
        The CSR rebuilds lazily on the next routed query."""
        if n and not self.index.has_incidences:
            raise ValueError(
                "latency routing needs the host-built index incidence "
                "lists"
            )
        self._host_route_max = int(n)

    def _build_host_csr(self):
        order = np.argsort(self.index.incidence_rank, kind="stable")
        self._rlist = self.index.incidence_protein[order]
        counts = np.bincount(
            self.index.incidence_rank, minlength=self.index.n_repeated
        )
        self._roff = np.zeros(self.index.n_repeated + 1, np.int64)
        np.cumsum(counts, out=self._roff[1:])

    def _build_device_blocks(self):
        """The packed corpus on the device as ``[W/128, N_pad, 128]``
        chunks, each contiguous. The chunks are copied up one by one from
        strided views of the host matrix, so the device never holds more
        than the one corpus copy (the JAX package pre-blocks on the host
        above 3 GiB for the same peak). On a mesh each shard holds the
        chunks ``[W/128, N_pad/D, 128]`` of its own rows on its device,
        and the weights."""
        bitset = self.bitset
        if bitset.w_pad % _BLOCK_WORDS:
            raise ValueError(
                f"W_pad {bitset.w_pad} must be a multiple of {_BLOCK_WORDS}"
            )
        # release the old corpus before the new one
        self._blocks = self._shard_blocks = None
        words = np.asarray(bitset.words).view(np.int32)
        if self._mesh is None:
            self._blocks = _upload_chunks(words, self.device)
            return
        d = self._mesh.size
        if bitset.n_pad % d:
            raise ValueError(
                f"N_pad={bitset.n_pad} must divide over {d} devices"
            )
        rows = bitset.n_pad // d
        self._shard_blocks = [
            _upload_chunks(words[k * rows : (k + 1) * rows], dev)
            for k, dev in enumerate(self._mesh.devices)
        ]
        self._shard_wts = ([None] * d if self._wts is None
                           else broadcast_from_first(self._wts, self._mesh))

    def _build_stream_source(self):
        """(Re)build the block feed from the CURRENT index/bitset — one
        definition shared by __init__ and rebuild_serving: the CSR block
        source (incidences staged on the device once), or the host
        matrix through the stream engine's pinned ring."""
        from uniprot_kmer_based_clustering_tpu_torch.ops.stream import (
            CSRBlockSource,
            _BlockFeed,
            _Window,
        )

        self._feed = None
        source, words = None, None
        if self._use_csr:
            source = CSRBlockSource(
                self.index.incidence_protein, self.index.incidence_rank,
                self.bitset.n_pad, self.bitset.w_pad,
            )
            source.prepare(
                self._stream_bs,
                -(-self.bitset.n_pad // self._stream_bs) * self._stream_bs,
                device=self.device,
            )
        else:
            words = np.asarray(self.bitset.words)
        self._feed = _BlockFeed(words, source, self._stream_bs, self.device,
                                slots=2, trace=self.stream_trace)
        self._window = _Window(self.device, self.stream_trace)

    def _counts_host(self, seqs: Sequence[str]) -> np.ndarray:
        """int32 [Q, n] shared counts via the rank-CSR walk (no device)."""
        n = self.bitset.n
        counts = np.zeros((len(seqs), n), np.int32)
        w = self._weights
        for qi, ranks in enumerate(query_ranks(self.index, seqs)):
            if ranks.shape[0] == 0:
                continue
            spans = [
                self._rlist[self._roff[r] : self._roff[r + 1]]
                for r in ranks
            ]
            js = np.concatenate(spans)
            if w is None:
                counts[qi] = np.bincount(js, minlength=n)
            else:
                wvals = np.repeat(
                    w[ranks].astype(np.int32),
                    self._roff[ranks + 1] - self._roff[ranks],
                )
                # np.bincount with weights returns float64; the int sums
                # are exact (≪ 2^53) so the cast is lossless
                counts[qi] = np.bincount(
                    js, weights=wvals, minlength=n
                ).astype(np.int32)
        return counts

    def add_proteins(
        self, seqs: Sequence[str], threshold: int = 10
    ) -> np.ndarray:
        """Append new proteins to the standing corpus, in place.

        The reference's incremental analogue is ``Tree::add_protein``
        (src/tree.rs:524-536). Extends the rank space for genuinely-new
        repeated k-mers (including docfreq promotions of standing unique
        k-mers), appends bitset rows for the new sequences WITHOUT
        re-encoding the standing corpus (kmers.append — append(A+B) ≡
        rebuild(A∪B)), and rebuilds the serving state (host CSR, device
        chunks — the corpus re-uploads once — or the stream feed).

        Returns the new-vs-all pairs over the alignment gate as an int64
        ``[P, 3]`` array of (i, j, shared count), i < j, global row ids
        (new rows start at the pre-append ``bitset.n``), sorted by
        (i, j) — the same shape as the batch sweep's pair rows.

        Weighted servers can't self-update: rank-aligned weights are
        derived from the OLD rank space and silently misweight after a
        rank shift — rebuild the server with recomputed weights instead.
        """
        if self.weighted:
            raise ValueError(
                "add_proteins on a weighted server: rank-aligned weights "
                "become stale when the rank space grows — recompute "
                "weights for the appended index and build a new server"
            )
        from uniprot_kmer_based_clustering_tpu_torch.kmers.append import (
            append_to_index,
        )

        n_old = self.bitset.n
        new_index, new_bitset = append_to_index(
            self.index, self.bitset, seqs
        )
        # commit the append ONLY if the serving rebuild succeeds; on
        # failure restore the pre-append state (the rebuild that was
        # working before) and re-raise the original error
        old_index, old_bitset = self.index, self.bitset
        self.index, self.bitset = new_index, new_bitset
        try:
            self.rebuild_serving()
        except BaseException as append_err:
            self.index, self.bitset = old_index, old_bitset
            try:
                self.rebuild_serving()
            except Exception as restore_err:
                # the restore failed too: the serving state matches
                # neither corpus, so every query raises until a rebuild
                # succeeds; both errors surface
                self._needs_rebuild = True
                warnings.warn(
                    "add_proteins rollback failed: serving state is "
                    f"inconsistent and queries are disabled ({restore_err!r});"
                    " call rebuild_serving() once the cause is fixed",
                    RuntimeWarning,
                )
                append_err.add_note(
                    f"rollback to the pre-append serving state ALSO "
                    f"failed ({restore_err!r}); server flagged "
                    f"needs_rebuild"
                )
            raise

        # new-vs-all report: each query row's matches -> (min, max,
        # count) rows; np.unique drops the doubly-reported new-new pairs
        # (equal counts) and gives (i, j, c)-lexicographic order
        parts = []
        for qi, m in enumerate(self.query(seqs, threshold=threshold)):
            m = np.asarray(m, np.int64).reshape(-1, 2)
            gi = n_old + qi
            m = m[m[:, 0] != gi]  # drop the self match
            if not len(m):
                continue
            parts.append(np.stack(
                [np.minimum(m[:, 0], gi), np.maximum(m[:, 0], gi), m[:, 1]],
                axis=1,
            ))
        if not parts:
            return np.zeros((0, 3), np.int64)
        return np.unique(np.concatenate(parts), axis=0)

    @property
    def needs_rebuild(self) -> bool:
        """True after an add_proteins rollback failed: queries raise
        until :meth:`rebuild_serving` succeeds."""
        return self._needs_rebuild

    def rebuild_serving(self):
        """Rebuild the serving state (host CSR, device chunks or stream
        feed) from the current index/bitset; clears the inconsistency
        flag set by a failed :meth:`add_proteins` rollback."""
        if self._stream_mode:
            self._build_stream_source()
        elif self._host_mode:
            self._build_host_csr()
        else:
            self._build_device_blocks()
        # the latency route's CSR is derived from the (possibly grown)
        # index — invalidate so the next routed query rebuilds it
        self._host_csr_built = False
        self._needs_rebuild = False

    def _stream_block(self, row0: int):
        """One [stream_bs, W] corpus block on the device, from the feed
        (CSR-materialized, or uploaded from the host matrix with the
        ragged tail zero-padded)."""
        return self._feed.put(row0 // self._stream_bs)

    def _query_rows(self, qwords: np.ndarray, rows: int):
        """Query rows int32 [rows, W] on the host, zero-padded, in pinned
        memory when the server is on CUDA (its copies do not block)."""
        qp = torch.zeros((rows, self.bitset.w_pad), dtype=torch.int32,
                         pin_memory=self.device.type == "cuda")
        qp[: qwords.shape[0]] = torch.from_numpy(qwords.view(np.int32))
        return qp

    def _upload_queries(self, qwords: np.ndarray, rows: int):
        """Query rows int32 [rows, W] on the device, zero-padded, through
        pinned memory and a non-blocking copy (no host synchronisation)."""
        return self._query_rows(qwords, rows).to(
            self.device, non_blocking=self.device.type == "cuda")

    def _resident_counts(self, qp):
        """int32 [N_pad, Q] counts of the query rows against the resident
        corpus."""
        return blocked_counts(qp, self._blocks, self._wts)

    def _mesh_counts(self, qwords: np.ndarray, nq: int):
        """int32 [N_pad, Q] counts on the mesh's first device: the query
        rows go to every shard, each shard counts them against its own
        rows, and the slices are gathered in shard (row) order."""
        qp = self._query_rows(qwords, _bucket(nq))
        parts = [
            blocked_counts(qp.to(dev, non_blocking=qp.is_pinned()), blocks,
                           wts)
            for dev, blocks, wts in zip(self._mesh.devices,
                                        self._shard_blocks, self._shard_wts)
        ]
        return gather_to_first(parts, self._mesh)

    def query_async(self, seqs: Sequence[str], threshold: int = 10):
        """Dispatch a batch without any synchronising fetch.

        Returns an opaque handle for :meth:`query_wait`. Several handles
        may be in flight at once — the device runs them back to back while
        earlier answers are fetched and post-processed:

            handles = [srv.query_async(b) for b in batches]   # enqueue
            answers = [srv.query_wait(h) for h in handles]    # drain

        On a device server this makes no host synchronisation (no
        ``.item()``, no blocking copy): the query rows go up through
        pinned memory and every result stays on the device until
        :meth:`query_wait`'s one fetch. Host-mode batches and batches
        the latency route takes have no device work to overlap: the
        handle keeps the sequences, and the CSR walk runs in
        :meth:`query_wait`, so this call never blocks on one. A stream
        batch waits only when more than ~4 GiB of blocks are queued
        (one CUDA event a block).
        """
        if self._needs_rebuild:
            raise RuntimeError(
                "serving state is inconsistent after a failed "
                "add_proteins rollback; call rebuild_serving()"
            )
        nq = len(seqs)
        if nq == 0:
            return {"nq": 0, "threshold": threshold}
        if self._host_mode or (
            nq <= self._host_route_max and self.index.has_incidences
        ):
            return {"nq": nq, "threshold": threshold,
                    "host_seqs": list(seqs)}
        qwords = pack_query_bitsets(self.index, seqs, self.bitset.w_pad)
        if self._mesh is not None:
            # the full counts: a top-k over the row-sharded counts would
            # need them on one device anyway
            return {"nq": nq, "threshold": threshold,
                    "counts_dev": self._mesh_counts(qwords, nq)}
        qp = self._upload_queries(qwords, _bucket(nq))
        if self._stream_mode:
            return self._stream_async(qwords, qp, nq, threshold)
        cap = min(self._topk_cap, self.bitset.n_pad)
        # the epilogue exists to shrink the fetch: [q_pad, 2·cap+1]
        # against the full [q_pad, n_pad]; past that break-even it is
        # skipped
        if 2 * cap + 1 >= self.bitset.n_pad:
            cap = 0
        counts = self._resident_counts(qp)
        if cap > 0:
            return {
                "nq": nq, "threshold": threshold, "cap": cap,
                "qwords": qwords,
                "packed_dev": topk_epilogue(counts, threshold,
                                            self.bitset.n, cap),
            }
        return {"nq": nq, "threshold": threshold, "counts_dev": counts}

    def _stream_async(self, qwords, qp, nq: int, threshold: int):
        """Stream every corpus row block through the device: counts and
        the per-block top-k epilogue, each block's packed lanes left on
        the device for query_wait's single fetch."""
        bs = self._stream_bs
        n = self.bitset.n
        # stream mode always answers through the per-block top-k (there
        # is no resident full-counts alternative); the cap only bounds the
        # per-(query, block) fetch — misses are redone exactly per block
        cap = max(1, min(self._topk_cap if self._topk_cap > 0 else 512, bs))
        # backpressure: the host runs at most max_inflight blocks ahead of
        # the device, so queued blocks never pile up past ~4 GiB
        block_bytes = bs * self.bitset.w_pad * 4
        max_inflight = max(2, int((4 << 30) // max(1, block_bytes)))
        blocks = []
        for row0 in range(0, self.bitset.n_pad, bs):
            counts = blocked_counts(qp, _word_chunks(self._stream_block(row0)),
                                    self._wts)
            blocks.append((row0, topk_epilogue(
                counts, threshold, max(0, min(bs, n - row0)), cap)))
            del counts
            self._window.push()
            self._window.drain(max_inflight)
        return {"nq": nq, "threshold": threshold, "cap": cap,
                "qwords": qwords, "stream_blocks": blocks}

    def _redo_rows(self, qwords: np.ndarray, over: np.ndarray, chunks,
                   cols: int) -> np.ndarray:
        """Full int32 counts [len(over), cols] of the overflowed query
        rows only, padded to their own power-of-two bucket."""
        op = self._upload_queries(qwords[over], _bucket(int(over.shape[0])))
        full = blocked_counts(op, chunks, self._wts)
        return full[:cols, : over.shape[0]].t().cpu().numpy()

    def query_wait(
        self, handle, top: Optional[int] = None
    ) -> List[np.ndarray]:
        """Fetch and finalize a :meth:`query_async` handle (one fetch;
        redone rows add one each)."""
        nq = handle["nq"]
        if nq == 0:
            return []
        threshold = handle["threshold"]
        if "stream_blocks" in handle:
            return self._stream_wait(handle, top)
        if "packed_dev" in handle:
            cap = handle["cap"]
            packed = handle["packed_dev"].cpu().numpy()
            vals, idx = packed[:, :cap], packed[:, cap : 2 * cap]
            nhits = packed[:, 2 * cap]
            over = np.nonzero(nhits[:nq] > cap)[0]
            full = None
            if over.shape[0]:
                # exactness first: only the overflowed rows are redone,
                # and everyone else keeps the lanes already in hand
                full = self._redo_rows(handle["qwords"], over, self._blocks,
                                       self.bitset.n)
            over_row = {int(q): k for k, q in enumerate(over)}
            out = []
            for qi in range(nq):
                if qi in over_row:
                    row = full[over_row[qi]]
                    hits = np.nonzero(row > threshold)[0]
                    m = _sorted_matches(hits, row[hits])
                else:
                    nh = int(nhits[qi])
                    m = np.stack([idx[qi, :nh].astype(np.int64),
                                  vals[qi, :nh].astype(np.int64)], axis=1)
                out.append(m[:top] if top is not None else m)
            return out
        if "counts_dev" in handle:
            # transposed on the device: each query's scan below then reads
            # one contiguous host row, not a column strided by Q
            counts = handle["counts_dev"][: self.bitset.n, :nq].t()
            counts = counts.contiguous().cpu().numpy()
        else:
            if not self._host_mode and not self._host_csr_built:
                self._build_host_csr()
                self._host_csr_built = True
            counts = self._counts_host(handle["host_seqs"])
        out: List[np.ndarray] = []
        for qi in range(nq):
            hits = np.nonzero(counts[qi] > threshold)[0]
            m = _sorted_matches(hits, counts[qi, hits])
            out.append(m[:top] if top is not None else m)
        return out

    def _stream_wait(self, handle, top: Optional[int]):
        nq, threshold, cap = handle["nq"], handle["threshold"], handle["cap"]
        # one fetch retires every block of the batch
        packed = torch.stack(
            [out for _row0, out in handle["stream_blocks"]]
        ).cpu().numpy()
        per_q = [[] for _ in range(nq)]
        for (row0, _out), arr in zip(handle["stream_blocks"], packed):
            vals, idx = arr[:, :cap], arr[:, cap : 2 * cap]
            nhits = arr[:, 2 * cap]
            over = np.nonzero(nhits[:nq] > cap)[0]
            valid = max(0, min(self._stream_bs, self.bitset.n - row0))
            full = None
            if over.shape[0]:
                # capacity miss in this block: rebuild the block once and
                # fetch full counts for ONLY the overflowed query rows
                full = self._redo_rows(
                    handle["qwords"], over,
                    _word_chunks(self._stream_block(row0)), valid)
            over_row = {int(q): k for k, q in enumerate(over)}
            for qi in range(nq):
                nh = int(nhits[qi])
                if nh == 0:
                    continue
                if nh > cap:
                    row = full[over_row[qi]]
                    hits = np.nonzero(row > threshold)[0]
                    per_q[qi].append((row0 + hits.astype(np.int64),
                                      row[hits].astype(np.int64)))
                else:
                    per_q[qi].append((row0 + idx[qi, :nh].astype(np.int64),
                                      vals[qi, :nh].astype(np.int64)))
        out = []
        for qi in range(nq):
            if not per_q[qi]:
                out.append(np.zeros((0, 2), np.int64))
                continue
            gidx = np.concatenate([g for g, _v in per_q[qi]])
            gval = np.concatenate([v for _g, v in per_q[qi]])
            m = _sorted_matches(gidx, gval)
            out.append(m[:top] if top is not None else m)
        return out

    def query(
        self,
        seqs: Sequence[str],
        threshold: int = 10,
        top: Optional[int] = None,
    ) -> List[np.ndarray]:
        """Shared-k-mer counts of each query sequence vs the corpus.

        Returns one int64 ``[M_q, 2]`` array per query — (corpus protein
        index, shared count), sorted by count descending then index —
        reporting corpus proteins with count **>** threshold (the
        pipeline's alignment gate), optionally only the best `top`.

        Synchronous: :meth:`query_async` then :meth:`query_wait`.
        """
        return self.query_wait(
            self.query_async(seqs, threshold=threshold), top=top
        )


def query_shared_kmers(
    index: KmerIndex,
    bitset: BitsetMatrix,
    seqs: Sequence[str],
    threshold: int = 10,
    weights: Optional[np.ndarray] = None,
    top: Optional[int] = None,
    device="cuda",
) -> List[np.ndarray]:
    """One-shot convenience wrapper: build a QueryServer on ``device`` and
    query it. Serving loops should construct the :class:`QueryServer`
    once instead (the corpus stays resident, the CSR built)."""
    return QueryServer(index, bitset, weights=weights, device=device).query(
        seqs, threshold=threshold, top=top
    )
