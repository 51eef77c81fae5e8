"""End-to-end pipeline on one torch device, or with its sweep on a mesh
of devices: FASTA → index → bitsets → sweep → clusters (components,
agglomerative or the tree).

The counterpart of the JAX package's ``pipeline.run_pipeline`` with the
same stage order, checkpoint keys and result fields. The host stages
(ingest, k-mer encode, doc-freq index, bit packing) are the port's own
copies of the JAX package's numpy/C++ modules (``io/``, ``kmers/``,
``utils/``, ``config.py``), with the same ``PipelineConfig.cache_key``
and ``CheckpointStore`` format, so a checkpoint directory written by
either package resumes in the other.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import os
from typing import Dict, Optional

import numpy as np

from uniprot_kmer_based_clustering_tpu_torch.config import PipelineConfig
from uniprot_kmer_based_clustering_tpu_torch.device import (
    resolve_device,
    synchronize,
)
from uniprot_kmer_based_clustering_tpu_torch.io.fasta import (
    ProteinTable,
    read_fasta,
)
from uniprot_kmer_based_clustering_tpu_torch.kmers.bitset import (
    BitsetMatrix,
    VirtualBitsetMatrix,
    pack_bitsets,
    padded_shape,
    pinned_of,
    pinned_words,
)
from uniprot_kmer_based_clustering_tpu_torch.kmers.encode import encode_kmers
from uniprot_kmer_based_clustering_tpu_torch.kmers.index import (
    KmerIndex,
    build_index,
)
from uniprot_kmer_based_clustering_tpu_torch.models.agglomerative import (
    agglomerative_cluster,
)
from uniprot_kmer_based_clustering_tpu_torch.models.components import (
    connected_components,
    connected_components_sharded,
)
from uniprot_kmer_based_clustering_tpu_torch.models.tree import (
    cluster_tree_labels,
)
from uniprot_kmer_based_clustering_tpu_torch.similarity.pairwise import (
    PairwiseResult,
    pairwise_similarity,
)
from uniprot_kmer_based_clustering_tpu_torch.utils.blosum import (
    rank_weights_int8,
)
from uniprot_kmer_based_clustering_tpu_torch.utils.checkpoint import (
    CheckpointStore,
)
from uniprot_kmer_based_clustering_tpu_torch.utils.timing import (
    StageTimers,
    span,
)


@dataclasses.dataclass
class PipelineResult:
    table: ProteinTable
    index: KmerIndex
    bitset: BitsetMatrix
    pairwise: Optional[PairwiseResult]
    cluster_labels: Optional[np.ndarray]
    timings: Dict[str, float]
    dendrogram: Optional[np.ndarray] = None

    def parity_report(self) -> Dict[str, int]:
        """The counters the reference prints to stderr, plus the pair
        gate."""
        report = {
            "proteins": self.table.n,
            "distinct_kmers": self.index.n_distinct,
            "unique_kmers": self.index.n_unique,
            "repeated_kmers": self.index.n_repeated,
            "incidences": self.index.nnz,
            "multigraph_edges": self.index.multigraph_edge_count(),
        }
        if self.pairwise is not None:
            report.update(self.pairwise.parity_counters())
        return report

    def cluster_summary(self) -> Dict[str, int]:
        if self.cluster_labels is None:
            return {}
        uniq, counts = np.unique(self.cluster_labels, return_counts=True)
        return {
            "clusters": int(uniq.shape[0]),
            "largest_cluster": int(counts.max()),
            "singletons": int((counts == 1).sum()),
        }


def _row_multiple(config: PipelineConfig, n: int) -> int:
    """N_pad granularity, as the JAX pipeline pads: tile-padded up to one
    strip; past that a multiple of lcm(strip, tile), with the ~3584-row
    strip when the strip is automatic."""
    strip = 3584 if config.strip is None else config.strip
    if config.strip is None and n <= 3584:
        return config.tile
    return (strip * config.tile) // math.gcd(strip, config.tile)


def blosum_weights(index: KmerIndex, config: PipelineConfig,
                   bitset: BitsetMatrix) -> Optional[np.ndarray]:
    """The int8 per-k-mer weights [W_pad*32] of ``--weighting blosum62``
    for the packed columns, as the JAX pipeline makes them; None for an
    unweighted config."""
    if config.weighting != "blosum62":
        return None
    return rank_weights_int8(index.repeated_codes, config.k, bitset.w_pad * 32)


def _fasta_fingerprint(fasta_path: str) -> str:
    """Checkpoint-key component for the input file's contents (path,
    size, mtime) — the same key the JAX pipeline writes."""
    st = os.stat(fasta_path)
    return f"{fasta_path}:{st.st_size}:{st.st_mtime_ns}"


def run_pipeline(
    fasta_path: str,
    config: Optional[PipelineConfig] = None,
    checkpoint_dir: Optional[str] = None,
    mesh=None,
    echo_timings: bool = False,
    stop_after: Optional[str] = None,
    device=None,
) -> PipelineResult:
    """Run the pipeline on one torch ``device`` ("cuda", the default, or
    "cpu"), or with its sweep on a ``mesh`` (``parallel.make_mesh``,
    ``make_mesh_2d``, or ``make_mesh(axis="k")``). The positional
    arguments are the JAX ``run_pipeline``'s; ``device`` comes last.

    On a mesh, the sweep and extraction run the mesh's layout — the flat
    row ring, the 2-D ring or the k-axis layout, or with
    ``engine="stream"`` on a flat mesh the out-of-core
    ``parallel.stream_mesh`` (:func:`_sharded_similarity`) — and
    components the sharded label propagation; the other stages run on the
    mesh's first device, which ``device`` may name but not contradict.
    On a mesh that spans several processes (``parallel.init_distributed``)
    every rank calls this with the same arguments: the host stages run
    replicated on each rank, the other stages on the rank's first local
    device, and every rank returns the one-process result; only rank 0
    writes checkpoints.
    The checkpoint artifacts do not depend on the device layout, so a
    single-device checkpoint resumes on any mesh and back, in either
    package.

    With ``checkpoint_dir``, the index and pairs artifacts persist and a
    rerun resumes from them; a one-pass ``engine="stream"`` run also
    persists its progress at stationary-group boundaries there. Each
    stage's time is closed after the
    device has finished its work, so it measures the work and not the
    launches.

    ``stop_after="pack"`` returns once the index and bitset exist,
    skipping the BLOSUM weights, the sweep and clustering — the serving
    path (``cli query``) needs only the standing corpus; ``pairwise`` and
    ``cluster_labels`` are None in the result.

    ``config.index_engine="device"`` builds the index and the bitset on
    ``device`` (``kmers/index_device.py``) instead of the host stages; such
    an index carries no incidence lists and is not checkpointed, and its
    bitset's words stay on ``device`` for the sweep.
    """
    if stop_after not in (None, "pack"):
        raise ValueError(f"unknown stop_after {stop_after!r}")
    config = config or PipelineConfig()
    if mesh is None:
        device = resolve_device("cuda" if device is None else device)
    else:
        _check_mesh_config(mesh, config)
        if device is not None and resolve_device(device) != mesh.home:
            raise ValueError(
                f"device {device!r} is not the mesh's first device "
                f"{mesh.home}"
            )
        device = mesh.home
    store = CheckpointStore(checkpoint_dir)
    timers = StageTimers(echo=echo_timings)

    @contextlib.contextmanager
    def stage(name):
        with timers.stage(name):
            yield
            synchronize(device)

    with stage("ingest"):
        table = read_fasta(fasta_path)

    fingerprint = _fasta_fingerprint(fasta_path)
    if config.index_engine == "device":
        with stage("index"):
            index, bitset = _device_index(table, config, device)
    else:
        key_index = config.cache_key("index", fingerprint)
        cached = store.load(key_index)
        index = None
        if cached is not None:
            index = KmerIndex(k=config.k, sampling=config.sampling, **cached)
        if index is None:
            with stage("encode"):
                codes, koff = encode_kmers(
                    table.seq_buf,
                    table.offsets,
                    config.k,
                    sampling=config.sampling,
                    seed=config.seed,
                )
            with stage("index"):
                index = build_index(codes, koff, config.k)
                index.sampling = config.sampling
            extra = (
                {"unique_owner": index.unique_owner}
                if index.unique_owner is not None
                else {}
            )
            store.save(
                key_index,
                codes=index.codes,
                doc_freq=index.doc_freq,
                repeated_codes=index.repeated_codes,
                incidence_protein=index.incidence_protein,
                incidence_rank=index.incidence_rank,
                hash_doc_freq=index.hash_doc_freq,
                **extra,
            )

        with stage("pack"):
            if (
                config.engine == "stream"
                and config.stream_source == "csr"
                and config.cluster in ("none", "components")
            ):
                # packless: the stream engine rebuilds its blocks on the
                # device from the incidence lists, so the dense matrix is
                # never built; only its geometry is carried, and any touch
                # of .words raises. Tree and agglomerative clustering read
                # the dense rows, so those configs keep the real pack
                bitset = VirtualBitsetMatrix.make(
                    table.n, index.n_repeated,
                    row_multiple=_row_multiple(config, table.n),
                )
            else:
                # words bound for a CUDA device are packed page-locked, so
                # the sweep's upload and the mesh's staging are DMAs
                row_multiple = _row_multiple(config, table.n)
                bitset = pack_bitsets(
                    index.incidence_protein,
                    index.incidence_rank,
                    table.n,
                    index.n_repeated,
                    row_multiple=row_multiple,
                    out=pinned_words(padded_shape(
                        table.n, index.n_repeated, row_multiple), device),
                )

    if stop_after == "pack":
        return PipelineResult(
            table=table,
            index=index,
            bitset=bitset,
            pairwise=None,
            cluster_labels=None,
            timings=timers.as_dict(),
        )

    weights = blosum_weights(index, config, bitset)

    key_pairs = config.cache_key("pairs", fingerprint)
    cached_pairs = store.load(key_pairs)
    if cached_pairs is not None:
        s = cached_pairs["stats"]
        pairwise = PairwiseResult(
            *(int(v) for v in s), pairs=cached_pairs["pairs"],
            cross_amr_only=config.cross_amr_only,
        )
    else:
        # a stream run checkpoints its sweep PROGRESS at stationary-group
        # boundaries under a sub-key of the pairs artifact (an interrupted
        # out-of-core pass resumes mid-sweep), but only into a store that
        # persists: with no checkpoint directory there is nothing to
        # resume from and no boundary work is done
        progress_key = key_pairs + "-stream-progress"
        checkpoints = (config.engine == "stream"
                       and store.path(progress_key) is not None)
        with stage("sweep"):
            if mesh is not None:
                pairwise = _sharded_similarity(
                    bitset, table, config, mesh, weights=weights,
                    index=index,
                )
            else:
                pairwise = pairwise_similarity(
                    bitset, table.amr_class_ids, config,
                    weights=weights, index=index,
                    checkpoint_store=store if checkpoints else None,
                    checkpoint_key=progress_key if checkpoints else None,
                    device=device,
                )
        store.save(
            key_pairs,
            pairs=pairwise.pairs,
            stats=np.array(
                [
                    pairwise.cross_weight,
                    pairwise.cross_pairs,
                    pairwise.cross_over,
                    pairwise.cross_max,
                    pairwise.same_weight,
                    pairwise.same_pairs,
                    pairwise.same_over,
                    pairwise.same_max,
                ],
                dtype=np.int64,
            ),
        )

    labels = None
    dendrogram = None
    if config.cluster == "components":
        with stage("cluster"):
            if mesh is not None:
                labels = connected_components_sharded(
                    mesh, pairwise.pairs, table.n
                )
            else:
                labels = connected_components(table.n, pairwise.pairs)
    elif config.cluster == "agglomerative":
        with stage("cluster"):
            # host-looped rounds, as the JAX pipeline runs them; each
            # round's argmax runs on the device
            agg = agglomerative_cluster(
                bitset, table.n, min_shared=config.min_shared, device=device
            )
            labels = agg.labels
            dendrogram = agg.merges
    elif config.cluster == "tree":
        with stage("cluster"):
            labels = cluster_tree_labels(bitset, table.n)

    return PipelineResult(
        table=table,
        index=index,
        bitset=bitset,
        pairwise=pairwise,
        cluster_labels=labels,
        timings=timers.as_dict(),
        dendrogram=dendrogram,
    )


def _device_index(table: ProteinTable, config: PipelineConfig, device):
    """Index + bitset built on ``device`` (``kmers/index_device.py``).

    k=5 takes the dense 21⁵ bincount, k=7 the global-sort build (the 21⁷
    universe has no dense form). Bit-identical to the host path; random10
    sampling stays on the host (the reference's sampler is positional,
    src/protein.rs:83-94). The index carries no incidence lists; the
    bitset's words stay on ``device``, where the sweep reads them, and
    come to the host only if something reads ``bitset.words``.
    """
    if config.sampling != "all":
        raise ValueError("index_engine='device' supports sampling='all'")
    from uniprot_kmer_based_clustering_tpu_torch.kmers.index_device import (
        build_device_index,
    )

    with span("index.device"):
        index, bitset = build_device_index(
            table.seq_buf, table.offsets, config.k,
            row_multiple=_row_multiple(config, table.n), device=device,
        )
    if index.n_repeated != bitset.n_bits:
        raise AssertionError(
            f"device index: {index.n_repeated} repeated codes in the "
            f"doc-freqs, {bitset.n_bits} in the rank space"
        )
    return index, bitset


def _check_mesh_config(mesh, config: PipelineConfig) -> None:
    """Refuse, before any work, what the mesh path does not carry: with
    the host block source the JAX pipeline refuses the stream engine on
    every mesh. With the CSR source the flat mesh runs the out-of-core
    ``parallel.stream_mesh``, and the 2-D ring and the k-axis layout take
    the packless in-core staging, as JAX's do."""
    if config.engine == "stream" and config.stream_source != "csr":
        raise ValueError(
            "engine='stream' on a mesh requires stream_source='csr' "
            "(per-device host-words streaming would re-upload the dense "
            "matrix D times)"
        )


def _sharded_similarity(bitset, table, config, mesh, weights=None,
                        index=None) -> PairwiseResult:
    """The mesh's layout (the JAX pipeline's mesh branch). On a flat
    mesh ``engine="stream"`` is the out-of-core one-pass
    ``parallel.stream_mesh.sweep_extract_stream_mesh`` (``bs`` from
    ``config.strip``, the tile from ``config.tile``, the pair capacity
    from ``config.extract_k``). Otherwise N_pad is padded
    to devices × 128-row tiles with class −1 rows; the matrix staged once
    — built on the devices from the index's incidence lists under
    ``stream_source="csr"`` (packless), else copied from the packed host
    matrix — then one fused pass (``extract="fused"``), or the layout's
    sweep and the extraction checked against the sweep's exact tile hits:
    under ``auto`` every sub-step's K1 appends its survivors to its
    card's pair buffers and extraction gathers them, with the second pass
    only where a card's survivors pass its slots; under ``two_pass`` the
    second pass, sized by those tile hits. Page-locked words
    (``bitset.pinned``) are staged by DMA to every card at once, so the
    staging returns before the copies end and the sweep's first products
    wait for them on each card's stream. Under a profiler the staging,
    the sweep (its appends and host reads included), the extraction (the
    cursor read, gather, sort and fetch, and any second pass) and the
    fused pass are the spans ``ukc.ring.stage``, ``.sweep``, ``.extract``
    and ``.fused``, and ``parallel.sharded.last_trace`` holds the call's
    counts."""
    from uniprot_kmer_based_clustering_tpu_torch.parallel.mesh import (
        mesh_layout,
        pad_for_mesh,
    )
    from uniprot_kmer_based_clustering_tpu_torch.parallel.sharded import (
        new_sweep_pairs,
        new_trace,
        sharded_extract_pairs,
        sharded_pairwise_fused,
        sharded_pairwise_similarity,
        sharded_pairwise_similarity_2d,
        sharded_pairwise_similarity_kaxis,
        stage_mesh_inputs,
        stage_mesh_inputs_csr,
        survivor_total,
    )

    if config.stream_source == "csr" and (
            index is None or not index.has_incidences):
        raise ValueError(
            "stream_source='csr' needs the host-built index incidence "
            "lists"
        )
    threshold = (
        config.effective_weighted_threshold(weights)
        if weights is not None
        else config.threshold
    )
    if config.engine == "stream" and mesh_layout(mesh) == "flat":
        # out of core: every shard sweeps its own block pairs from the
        # replicated incidence lists, so the dense matrix exists nowhere
        from uniprot_kmer_based_clustering_tpu_torch.ops.stream import (
            CSRBlockSource,
        )
        from uniprot_kmer_based_clustering_tpu_torch.parallel.stream_mesh import (
            sweep_extract_stream_mesh,
        )

        src = CSRBlockSource(index.incidence_protein, index.incidence_rank,
                             bitset.n_pad, bitset.w_pad)
        row_stats, _, _, pairs = sweep_extract_stream_mesh(
            mesh, np.asarray(table.amr_class_ids, np.int32), bitset.n,
            threshold, block_source=src, bs=config.strip, block=config.tile,
            weights=weights, cross_amr_only=config.cross_amr_only,
            cap=config.extract_k or None,
        )
        return PairwiseResult.from_row_stats(
            row_stats, pairs, cross_amr_only=config.cross_amr_only
        )

    sweep = {
        "flat": sharded_pairwise_similarity,
        "2d": sharded_pairwise_similarity_2d,
        "kaxis": sharded_pairwise_similarity_kaxis,
    }[mesh_layout(mesh)]
    block_tile = 128
    n_pad = pad_for_mesh(bitset.n_pad, mesh.size, block_tile)
    classes = np.full(n_pad, -1, dtype=np.int32)
    classes[: bitset.n] = np.asarray(table.amr_class_ids, np.int32)
    trace = new_trace()
    with span("ring.stage"):
        if config.stream_source == "csr":
            words, classes = stage_mesh_inputs_csr(
                mesh, index.incidence_protein, index.incidence_rank, n_pad,
                bitset.w_pad, classes, trace=trace,
            )
        else:
            # page-locked words go as the allocator's int32 tensor, whose
            # row shards each card then loads by DMA, all at once
            words = pinned_of(bitset)
            if words is None:
                words = bitset.words
            if n_pad != bitset.n_pad:
                words = np.zeros((n_pad, bitset.w_pad), dtype=np.uint32)
                words[: bitset.n_pad] = bitset.words
            words, classes = stage_mesh_inputs(mesh, words, classes, trace)

    if config.extract == "fused":
        with span("ring.fused"):
            row_stats, _, _, pairs = sharded_pairwise_fused(
                mesh, words, classes, bitset.n, threshold,
                block_tile=block_tile, weights=weights,
                cross_amr_only=config.cross_amr_only,
                k=config.extract_k or None, trace=trace,
            )
        return PairwiseResult.from_row_stats(
            row_stats, pairs, cross_amr_only=config.cross_amr_only
        )
    with span("ring.sweep"):
        appended = (new_sweep_pairs(mesh) if config.extract == "auto"
                    else None)
        row_stats, tile_hits, _ = sweep(
            mesh, words, classes, bitset.n, threshold, block_tile,
            weights=weights, trace=trace, pairs=appended,
            cross_amr_only=config.cross_amr_only,
        )
    total = survivor_total(tile_hits, config.cross_amr_only, trace)
    with span("ring.extract"):
        pairs = sharded_extract_pairs(
            mesh, words, classes, bitset.n, threshold,
            block_tile=block_tile, weights=weights,
            cross_amr_only=config.cross_amr_only,
            cap=max(1 << 18, total), expected_total=total, trace=trace,
            appended=appended,
        )
    return PairwiseResult.from_row_stats(
        row_stats, pairs, cross_amr_only=config.cross_amr_only
    )
