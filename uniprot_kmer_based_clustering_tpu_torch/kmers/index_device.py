"""Device-side index build: doc-freq → rank hash → packed bitsets, all on
one torch device.

Counterpart of the JAX package's ``kmers/index_device.py``. The 5-mer
universe is only 21⁵ = 4,084,101 codes, so the document frequency is one
dense bincount and the rank hash is a cumsum over the repeated mask — no
host sort. The packed bitset is built by a scatter of single-bit words
into ``words[row, rank >> 5]``. Several distinct ranks of one row can land
in the same word, so the scatter ACCUMULATES (``index_add_`` of distinct
powers of two, which equals the OR); bit 31 is the int32 sign bit, taken
from the stream engine's bit table (``ops.stream._BIT``).

k=7: the 21⁷ ≈ 1.8e9-code universe has no dense form, so the build
sorts the ~nnz incidence codes globally (:func:`build_bitset_device_sorted`):
sort → distinct codes and their counts → repeated-rank cumsum → each
incidence's rank written back through the sort permutation → the same
single-bit scatter.

torch shapes may depend on the data, so where the JAX build runs two
passes (a first one that fetches the sizes so the second compiles with
static shapes) this one runs one and fetches the sizes as it goes. The
arrays equal the host build (``kmers/index.py`` + ``kmers/bitset.py``)
bit for bit; ``tests/test_torch_index_device.py`` holds them against the
JAX device build and the host build.

Words come back as int32 tensors holding the uint32 bit patterns (torch's
uint32 lacks ops); ``numpy().view(np.uint32)`` gives the host layout.

The pipeline's build (:func:`build_device_index`) sends the flat residue
bytes up, makes the padded residue matrix on the device, and leaves the
words there (``kmers.bitset.DeviceBitsetMatrix``): only the residues go
up and only the codes and doc-freqs come down. Under a profiler its phases
are the spans ``ukc.index.device.{residues,encode,sort,scatter,fetch}``
(``utils.timing.span``); :data:`last_trace` counts what it moved.
"""

from __future__ import annotations

import numpy as np
import torch

from uniprot_kmer_based_clustering_tpu_torch.kmers.bitset import (
    DeviceBitsetMatrix,
)
from uniprot_kmer_based_clustering_tpu_torch.kmers.encode import (
    encode_kmers_device,
    residues_to_indices,
)
from uniprot_kmer_based_clustering_tpu_torch.kmers.index import (
    KmerIndex,
    doc_freq_dense_device,
)
from uniprot_kmer_based_clustering_tpu_torch.utils.timing import span

_SENT = 2**31 - 1  # sorts after every k-mer code (21^7 < 2^31)

#: Counts of the most recent device build: ``k``; ``incidence_slots``,
#: the per-row deduplicated window slots it ranks (padding included: the
#: slots k=7's global sort orders); ``distinct`` and ``repeated`` codes;
#: ``words_bytes``, the packed words it made; ``host_bytes``, the bytes
#: it moved between host arrays and the device, both ways summed; and
#: ``syncs``, its host waits. Times are the spans'.
last_trace: dict = {}


def _new_trace(k: int) -> dict:
    """A fresh :data:`last_trace`, which the build then fills."""
    global last_trace
    last_trace = dict(k=k, incidence_slots=0, distinct=0, repeated=0,
                      words_bytes=0, host_bytes=0, syncs=0)
    return last_trace


def _check_flat_index_space(n_pad: int, w_pad: int) -> None:
    # The JAX build flattens (row, word) to an int32 scatter index, which
    # would wrap past 2^31; the port's index is int64 and could go
    # further, but keeps the JAX bound so both packages refuse alike.
    if n_pad * w_pad + 1 > 2**31 - 1:
        raise ValueError(
            f"device index build needs N_pad*W_pad < 2^31 flat scatter "
            f"indices (got {n_pad}*{w_pad}); use index_engine='host' at "
            f"this scale"
        )


def _row_dedup(codes, valid, sent=_SENT):
    """Sorted per-row codes with duplicates (and padding) → ``sent``.

    The one per-row first-occurrence dedup shared by every device index
    build; the sentinel is the only thing that varies (the dense paths use
    the universe size so the bincount can absorb it)."""
    c = torch.where(valid, codes, sent)
    c = torch.sort(c, dim=1).values
    first = torch.ones_like(c, dtype=torch.bool)
    first[:, 1:] = c[:, 1:] != c[:, :-1]
    return torch.where(first & (c < sent), c, sent)


def _scatter_bits(rank, keep, n_pad: int, w_pad: int):
    """int32 words [n_pad, w_pad]: bit ``rank & 31`` of word ``rank >> 5``
    set in its row for every kept [rows, cols] rank. Distinct bits of one
    word add, which is their OR; dropped lanes add 0 to word 0."""
    from uniprot_kmer_based_clustering_tpu_torch.ops.stream import _BIT

    dev = rank.device
    rows = torch.arange(rank.shape[0], dtype=torch.int64, device=dev)
    flat = rows[:, None] * w_pad + (rank.to(torch.int64) >> 5)
    table = torch.tensor(_BIT, dtype=torch.int32, device=dev)
    bit = table[(rank & 31).to(torch.int64)]
    words = torch.zeros(n_pad * w_pad, dtype=torch.int32, device=dev)
    words.index_add_(0, torch.where(keep, flat, 0).reshape(-1),
                     torch.where(keep, bit, 0).reshape(-1))
    return words.view(n_pad, w_pad)


def _device_residues(seq_buf: np.ndarray, offsets: np.ndarray, device,
                     trace: dict):
    """(uint8 [N, Lmax] alphabet indices, int64 [N] lengths) on
    ``device``, the padded residue matrix that the device encode reads:
    the flat residue bytes, the offsets and the alphabet table go up, and
    the lookup and the scatter into the matrix (padding 0) run there."""
    offsets = np.asarray(offsets, np.int64)
    n = offsets.shape[0] - 1
    lmax = int(np.diff(offsets).max()) if n > 0 else 1
    total = int(offsets[-1] - offsets[0]) if n > 0 else 0
    table = residues_to_indices(np.arange(256, dtype=np.uint8))
    buf, offs, table = _upload(
        (np.asarray(seq_buf, np.uint8)[offsets[0] : offsets[0] + total],
         offsets, table), device, trace)
    lens = offs[1:] - offs[:-1]
    shift = (torch.arange(n, dtype=torch.int64, device=device) * lmax
             - (offs[:-1] - offs[0]))
    flat = torch.arange(total, dtype=torch.int64, device=device) + \
        torch.repeat_interleave(shift, lens, output_size=total)
    mat = torch.zeros(n * lmax, dtype=torch.uint8, device=device)
    mat[flat] = table[buf.to(torch.int64)]
    return mat.view(n, lmax), lens


def _upload(arrays, device, trace: dict) -> list:
    """Host arrays as tensors on ``device``, their bytes counted."""
    out = []
    for a in arrays:
        t = torch.from_numpy(np.ascontiguousarray(a))
        trace["host_bytes"] += t.nbytes
        out.append(t.to(device))
    return out


def _encode_padded(res, lens, n: int, k: int, row_multiple: int):
    """(codes, valid, n_pad): the device encode with rows padded to the
    row multiple (padding rows have no valid window)."""
    codes, valid = encode_kmers_device(res, lens, k)
    n_pad = -(-max(n, 1) // row_multiple) * row_multiple
    if codes.shape[0] != n_pad:
        pad = n_pad - codes.shape[0]
        codes = torch.nn.functional.pad(codes, (0, 0, 0, pad))
        valid = torch.nn.functional.pad(valid, (0, 0, 0, pad))
    return codes, valid, n_pad


def _w_pad(n_repeated: int, word_multiple: int) -> int:
    return -(-max(n_repeated, 1) // 32 // word_multiple) * word_multiple


def _dense_build(res, lens, n: int, row_multiple: int, word_multiple: int,
                 trace: dict):
    """k=5 from the residues on the device: (words, freq, n_repeated)."""
    universe = 21**5
    with span("index.device.encode"):
        codes, valid, n_pad = _encode_padded(res, lens, n, 5, row_multiple)
    trace["incidence_slots"] = codes.numel()
    with span("index.device.sort"):
        freq = doc_freq_dense_device(codes, valid, 5)
        repeated = freq >= 2
        # rank of a code = #repeated codes before it (ascending-code rank,
        # the host path's dense-rank hash)
        rank = torch.cumsum(repeated.to(torch.int32), 0,
                            dtype=torch.int32) - 1
        n_distinct, n_repeated = torch.stack(
            [torch.count_nonzero(freq), torch.count_nonzero(repeated)]
        ).tolist()
        trace["syncs"] += 1
        # the rows deduped again, for each incidence's code
        inc_code = _row_dedup(codes, valid, sent=universe)
        del codes, valid
        safe = torch.clamp(inc_code, max=universe - 1).to(torch.int64)
        keep = (inc_code < universe) & repeated[safe]
        inc_rank = rank[safe]
        del inc_code, safe, rank, repeated
    w_pad = _w_pad(n_repeated, word_multiple)
    _check_flat_index_space(n_pad, w_pad)
    with span("index.device.scatter"):
        words = _scatter_bits(inc_rank, keep, n_pad, w_pad)
    trace.update(distinct=n_distinct, repeated=n_repeated,
                 words_bytes=words.nbytes)
    return words, freq, n_repeated


def _sorted_build(res, lens, n: int, k: int, row_multiple: int,
                  word_multiple: int, trace: dict):
    """Any k from the residues on the device: (words, codes, doc_freq,
    n_repeated), codes and doc-freqs fetched to the host in one copy.
    Two host waits: the size of ``unique_consecutive``'s output, and the
    fetch, which also gives the number of repeated codes, so the ranks
    need none."""
    with span("index.device.encode"):
        codes, valid, n_pad = _encode_padded(res, lens, n, k, row_multiple)
        inc = _row_dedup(codes, valid)
        del codes, valid
    trace["incidence_slots"] = inc.numel()
    with span("index.device.sort"):
        s, order = torch.sort(inc.reshape(-1))
        del inc
        uniq, counts = torch.unique_consecutive(s, return_counts=True)
        trace["syncs"] += 1
        # the sentinel (padding and repeats within a row) sorts last;
        # ascending-code rank over the repeated codes, per distinct code,
        # then per sorted slot, then back at each slot's position
        repeated = (counts >= 2) & (uniq != _SENT)
        grank = torch.cumsum(repeated.to(torch.int32), 0,
                             dtype=torch.int32) - 1
        grank = torch.where(repeated, grank, -1)
        rank = torch.empty_like(s)
        rank[order] = torch.repeat_interleave(grank, counts,
                                              output_size=s.numel())
        del s, order, repeated, grank
    with span("index.device.fetch"):
        # 21^7 < 2^31 and a doc-freq <= N_pad * W: both fit int32
        host = torch.stack([uniq, counts.to(torch.int32)]).cpu().numpy()
        trace["host_bytes"] += host.nbytes
        trace["syncs"] += 1
        del uniq, counts
    d = host.shape[1] - int(host[0, -1] == _SENT)
    ucodes, dfreq = host[0, :d].astype(np.int64), host[1, :d].astype(np.int64)
    n_repeated = int(np.count_nonzero(dfreq >= 2))
    w_pad = _w_pad(n_repeated, word_multiple)
    if d:
        _check_flat_index_space(n_pad, w_pad)
    with span("index.device.scatter"):
        rank = rank.view(n_pad, -1)
        words = _scatter_bits(torch.clamp(rank, min=0), rank >= 0, n_pad,
                              w_pad)
    trace.update(distinct=d, repeated=n_repeated, words_bytes=words.nbytes)
    return words, ucodes, dfreq, n_repeated


def build_bitset_device(
    residue_idx: np.ndarray,
    lengths: np.ndarray,
    n: int,
    row_multiple: int = 512,
    word_multiple: int = 128,
    device="cuda",
):
    """Full device index build for k=5.

    Args:
      residue_idx: int [N, Lmax] alphabet indices (pad arbitrary).
      lengths: int32 [N] true lengths.
      device: the torch device the build runs on.

    Returns (words int32 [N_pad, W_pad] tensor, freq int32 [21^5] tensor,
    n_repeated int), both tensors on ``device``. The words' bits are the
    host ``build_index`` + ``pack_bitsets`` layout exactly.
    """
    from uniprot_kmer_based_clustering_tpu_torch.device import resolve_device

    trace = _new_trace(5)
    with span("index.device.residues"):
        res, lens = _upload((residue_idx, lengths), resolve_device(device),
                            trace)
    return _dense_build(res, lens, n, row_multiple, word_multiple, trace)


def build_bitset_device_sorted(
    residue_idx: np.ndarray,
    lengths: np.ndarray,
    n: int,
    k: int,
    row_multiple: int = 512,
    word_multiple: int = 128,
    device="cuda",
):
    """Device index build for any k (sort-based; the k=7 path).

    Returns (words int32 [N_pad, W_pad] tensor on ``device``, codes int64
    [D] ascending, doc_freq int64 [D], n_repeated) with numpy codes and
    doc-freqs. The words' bits are the host ``build_index`` +
    ``pack_bitsets`` layout exactly.
    """
    from uniprot_kmer_based_clustering_tpu_torch.device import resolve_device

    trace = _new_trace(k)
    with span("index.device.residues"):
        res, lens = _upload((residue_idx, lengths), resolve_device(device),
                            trace)
    return _sorted_build(res, lens, n, k, row_multiple, word_multiple,
                         trace)


def build_device_index(seq_buf: np.ndarray, offsets: np.ndarray, k: int,
                       row_multiple: int = 512, device="cuda"):
    """The pipeline's device build (``index_engine="device"``): the padded
    residue matrix made on the device from the flat residue bytes, then
    k=5's dense build or the sorted build of any other k.

    Returns (KmerIndex with no incidence lists, DeviceBitsetMatrix whose
    words stay on ``device``): the words never pass through the host.
    """
    from uniprot_kmer_based_clustering_tpu_torch.device import resolve_device

    trace = _new_trace(k)
    with span("index.device.residues"):
        res, lens = _device_residues(seq_buf, offsets,
                                     resolve_device(device), trace)
    n = lens.shape[0]
    if k == 5:
        words, freq, n_repeated = _dense_build(res, lens, n, row_multiple,
                                               128, trace)
        with span("index.device.fetch"):
            freq = freq.cpu().numpy()
            trace["host_bytes"] += freq.nbytes
            trace["syncs"] += 1
        index = KmerIndex.from_dense_freq(freq, k)
    else:
        words, codes, counts, n_repeated = _sorted_build(
            res, lens, n, k, row_multiple, 128, trace)
        index = KmerIndex.from_sparse_freq(codes, counts, k)
    return index, DeviceBitsetMatrix(words, n=n, n_bits=n_repeated)
