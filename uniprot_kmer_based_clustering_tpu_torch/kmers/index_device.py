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
"""

from __future__ import annotations

import numpy as np
import torch

from uniprot_kmer_based_clustering_tpu_torch.kmers.encode import (
    encode_kmers_device,
)
from uniprot_kmer_based_clustering_tpu_torch.kmers.index import (
    doc_freq_dense_device,
)

_SENT = 2**31 - 1  # sorts after every k-mer code (21^7 < 2^31)


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


def _encode_padded(residue_idx, lengths, n: int, k: int, row_multiple: int,
                   device):
    """(codes, valid, n_pad): the device encode with rows padded to the
    row multiple (padding rows have no valid window)."""
    res = torch.as_tensor(np.asarray(residue_idx, np.int32)).to(device)
    lens = torch.as_tensor(np.asarray(lengths, np.int32)).to(device)
    codes, valid = encode_kmers_device(res, lens, k)
    n_pad = -(-max(n, 1) // row_multiple) * row_multiple
    if codes.shape[0] != n_pad:
        pad = n_pad - codes.shape[0]
        codes = torch.nn.functional.pad(codes, (0, 0, 0, pad))
        valid = torch.nn.functional.pad(valid, (0, 0, 0, pad))
    return codes, valid, n_pad


def _w_pad(n_repeated: int, word_multiple: int) -> int:
    return -(-max(n_repeated, 1) // 32 // word_multiple) * word_multiple


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
      residue_idx: int32 [N, Lmax] alphabet indices (pad arbitrary).
      lengths: int32 [N] true lengths.
      device: the torch device the build runs on.

    Returns (words int32 [N_pad, W_pad] tensor, freq int32 [21^5] tensor,
    n_repeated int), both tensors on ``device``. The words' bits are the
    host ``build_index`` + ``pack_bitsets`` layout exactly.
    """
    from uniprot_kmer_based_clustering_tpu_torch.device import resolve_device

    device = resolve_device(device)
    universe = 21**5
    codes, valid, n_pad = _encode_padded(residue_idx, lengths, n, 5,
                                         row_multiple, device)
    freq = doc_freq_dense_device(codes, valid, 5)
    repeated = freq >= 2
    # rank of a code = #repeated codes before it (ascending-code rank, the
    # host path's dense-rank hash)
    rank = torch.cumsum(repeated.to(torch.int32), 0, dtype=torch.int32) - 1
    n_repeated = int(rank[-1].item()) + 1
    w_pad = _w_pad(n_repeated, word_multiple)
    _check_flat_index_space(n_pad, w_pad)
    # the rows deduped again, for each incidence's code
    inc_code = _row_dedup(codes, valid, sent=universe)
    safe = torch.clamp(inc_code, max=universe - 1).to(torch.int64)
    keep = (inc_code < universe) & repeated[safe]
    words = _scatter_bits(rank[safe], keep, n_pad, w_pad)
    return words, freq, n_repeated


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

    device = resolve_device(device)
    codes, valid, n_pad = _encode_padded(residue_idx, lengths, n, k,
                                         row_multiple, device)
    inc = _row_dedup(codes, valid)
    s, order = torch.sort(inc.reshape(-1))
    # the sentinels sort last: the codes are a prefix of the sorted list
    m_codes = int((s < _SENT).sum().item())
    uniq, counts = torch.unique_consecutive(s[:m_codes], return_counts=True)
    n_distinct = int(uniq.shape[0])
    repeated = counts >= 2
    n_repeated = int(repeated.sum().item())
    w_pad = _w_pad(n_repeated, word_multiple)
    if n_distinct == 0:
        # every sequence shorter than k: empty index, all-zero bitset
        return (
            torch.zeros((n_pad, w_pad), dtype=torch.int32, device=device),
            np.zeros(0, np.int64),
            np.zeros(0, np.int64),
            0,
        )
    _check_flat_index_space(n_pad, w_pad)
    # ascending-code rank over the repeated codes, per distinct code, then
    # per sorted incidence, then back at each incidence's position
    grank = torch.cumsum(repeated.to(torch.int32), 0, dtype=torch.int32) - 1
    grank = torch.where(repeated, grank, -1)
    r_sorted = torch.repeat_interleave(grank, counts)
    rank = torch.full((s.shape[0],), -1, dtype=torch.int32, device=device)
    rank[order[:m_codes]] = r_sorted
    rank = rank.view(inc.shape)
    words = _scatter_bits(torch.clamp(rank, min=0), rank >= 0, n_pad, w_pad)
    return (
        words,
        uniq.cpu().numpy().astype(np.int64),
        counts.cpu().numpy().astype(np.int64),
        n_repeated,
    )
