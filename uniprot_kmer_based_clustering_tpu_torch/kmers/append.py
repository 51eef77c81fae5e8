"""Incremental corpus append — extend a standing index/bitset with new
proteins without re-encoding the standing corpus.

The reference's clustering tree is incremental by design:
``Tree::add_protein`` (src/tree.rs:524-536) inserts one protein's k-mer
bitset into the standing structure. The framework's batch index was
rebuild-only; this module closes that gap with exact set semantics:

    append(A, B)  ≡  rebuild(A ∪ B)      (pinned pair-for-pair in tests)

The subtle part is docfreq **promotion**: a k-mer unique in the standing
corpus (docfreq 1 — excluded from the rank space and from every bitset)
can reach docfreq ≥ 2 once an appended protein also contains it. Its
owner row's bit must then be set, but the owner's raw sequence is gone.
:class:`~uniprot_kmer_based_clustering_tpu_torch.kmers.index.KmerIndex`
therefore carries ``unique_owner`` — the single protein containing each
unique code — recorded at build time (docfreq==1 ⇒ exactly one owner, a
few bytes per unique code). With that, append is pure index algebra:

  1. encode ONLY the new sequences; dedup per protein (the reference's
     per-protein sort+dedup, src/main.rs:100-102);
  2. merge doc-freqs over the union code set;
  3. repeated set = docfreq ≥ 2 of the union; the rank space re-derives
     as the dense ascending-code rank (old ranks embed monotonically —
     an old repeated code can never stop being repeated);
  4. incidence list = old incidences re-keyed to the new rank space
     ∪ promoted (owner, code) incidences ∪ new-protein incidences;
  5. repack the bitset from incidences (packing is cheap — the encode
     of 3.4M residues is what append avoids re-paying).

Restricted to ``sampling="all"`` (the live reference path): "random10"
derives per-protein sample streams from the GLOBAL protein index, which
an append-only encode cannot reproduce.

The port's own copy of the JAX package's ``kmers/append.py`` (host numpy,
the same error messages).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

from uniprot_kmer_based_clustering_tpu_torch.kmers.bitset import (
    BitsetMatrix,
    pack_bitsets,
)
from uniprot_kmer_based_clustering_tpu_torch.kmers.encode import (
    encode_kmers,
    seqs_to_buffer,
)
from uniprot_kmer_based_clustering_tpu_torch.kmers.index import KmerIndex


def append_to_index(
    index: KmerIndex,
    bitset: BitsetMatrix,
    seqs: Sequence[str],
    row_multiple: int = 512,
    word_multiple: int = 128,
) -> Tuple[KmerIndex, BitsetMatrix]:
    """Append new protein sequences to a standing (index, bitset).

    Returns a NEW (index, bitset) covering the old corpus plus the new
    proteins (rows ``bitset.n .. bitset.n+len(seqs)-1``), bit-identical
    to a from-scratch rebuild over the concatenated dataset with the
    same packing parameters. The inputs are not mutated.

    Requires an index that carries host incidence lists and unique-code
    owners (host/native ``build_index`` output, or a checkpoint saved by
    the pipeline); device-built indexes drop both and cannot append.
    """
    if not index.has_incidences:
        raise ValueError(
            "append needs host incidence lists; this index was built by "
            "the device path (index_engine='device') which drops them — "
            "rebuild with the host/native engine to enable appends"
        )
    if index.unique_owner is None:
        raise ValueError(
            "append needs unique-code owners (index.unique_owner); "
            "rebuild the index with kmers.index.build_index"
        )
    if getattr(index, "sampling", "all") != "all":
        raise ValueError(
            "append requires a sampling='all' index: new sequences are "
            "encoded with the full k-mer stream, so appending onto a "
            f"'{index.sampling}'-sampled corpus silently breaks "
            "append(A+B) == rebuild(A|B) — rebuild instead"
        )
    if len(seqs) == 0:
        return index, bitset

    n_old = bitset.n
    universe = 21**index.k

    # 1. encode + per-protein dedup of the NEW sequences only
    buf, offsets = seqs_to_buffer(seqs)
    codes, koff = encode_kmers(buf, offsets, index.k)
    m = len(seqs)
    protein_of = np.repeat(
        np.arange(m, dtype=np.int64), np.diff(koff)
    )
    keys = np.unique(protein_of * universe + codes)
    b_p = (keys // universe).astype(np.int64) + n_old
    b_c = keys % universe

    # 2. merged doc-freq over the union code set
    b_codes, b_freq = np.unique(b_c, return_counts=True)
    merged = np.union1d(index.codes, b_codes)
    freq = np.zeros(merged.shape[0], np.int64)
    freq[np.searchsorted(merged, index.codes)] += index.doc_freq
    freq[np.searchsorted(merged, b_codes)] += b_freq

    # 3. new rank space
    repeated_mask = freq >= 2
    new_repeated = merged[repeated_mask]
    r_new = new_repeated.shape[0]

    # 4a. old incidences re-keyed: old rank → code → new rank (exact —
    # every old repeated code stays repeated, so the lookup always hits)
    old_codes_of_inc = index.repeated_codes[index.incidence_rank]
    old_r = np.searchsorted(new_repeated, old_codes_of_inc)
    old_p = index.incidence_protein.astype(np.int64)

    # 4b. promoted incidences: codes unique in the old corpus that the
    # new proteins pushed to docfreq ≥ 2 — their sole old owner's bit
    # joins the matrix now
    old_unique = index.codes[index.doc_freq == 1]
    pos = (
        np.searchsorted(new_repeated, old_unique)
        if r_new
        else np.zeros(old_unique.shape[0], np.int64)
    )
    pos = np.clip(pos, 0, max(r_new - 1, 0))
    promoted = (
        new_repeated[pos] == old_unique
        if r_new
        else np.zeros(old_unique.shape[0], bool)
    )
    promo_p = index.unique_owner[promoted].astype(np.int64)
    promo_r = pos[promoted]

    # 4c. new-protein incidences restricted to the new repeated set
    bpos = np.searchsorted(new_repeated, b_c) if r_new else np.zeros(
        b_c.shape[0], np.int64
    )
    bpos = np.clip(bpos, 0, max(r_new - 1, 0))
    bkeep = (
        new_repeated[bpos] == b_c
        if r_new
        else np.zeros(b_c.shape[0], bool)
    )

    inc_p = np.concatenate([old_p, promo_p, b_p[bkeep]])
    inc_r = np.concatenate([old_r, promo_r, bpos[bkeep]])
    order = np.lexsort((inc_r, inc_p))  # (protein, rank) — build parity
    inc_p = inc_p[order].astype(np.int32)
    inc_r = inc_r[order].astype(np.int32)

    # 5. owners of the codes still/newly unique: carried from the old
    # corpus (still-unique) or the single new protein (new docfreq-1)
    new_unique = merged[~repeated_mask]
    owner = np.full(new_unique.shape[0], -1, np.int32)
    if new_unique.shape[0]:
        upos = np.searchsorted(new_unique, old_unique)
        upos = np.clip(upos, 0, new_unique.shape[0] - 1)
        still = new_unique[upos] == old_unique
        owner[upos[still]] = index.unique_owner[still]
        b1 = b_freq == 1
        if b1.any():
            corder = np.argsort(b_c, kind="stable")
            j = np.searchsorted(b_c[corder], b_codes[b1])
            cand_owner = b_p[corder][j].astype(np.int32)
            wpos = np.searchsorted(new_unique, b_codes[b1])
            wpos = np.clip(wpos, 0, new_unique.shape[0] - 1)
            wok = new_unique[wpos] == b_codes[b1]
            owner[wpos[wok]] = cand_owner[wok]

    new_index = KmerIndex(
        k=index.k,
        codes=merged,
        doc_freq=freq,
        repeated_codes=new_repeated,
        incidence_protein=inc_p,
        incidence_rank=inc_r,
        hash_doc_freq=freq[repeated_mask],
        unique_owner=owner,
    )
    new_bitset = pack_bitsets(
        inc_p,
        inc_r,
        n_old + m,
        r_new,
        row_multiple=row_multiple,
        word_multiple=word_multiple,
    )
    return new_index, new_bitset
