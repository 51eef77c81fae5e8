"""Host-side FASTA ingest.

Replaces the reference's ``seq_io`` reader-thread + worker pipeline
(``src/main.rs:62-74``) with a flat-buffer parse: one pass over the file
produces a concatenated residue byte buffer plus per-protein offsets — the
natural feed for device arrays. A native C++ parser (``native/ukc_native.cpp``)
is used when built; the numpy fallback below is behavior-identical.

Semantics matched to the reference:
  * record id = header token up to the first whitespace (seq_io ``Record::id``,
    used at ``src/protein.rs:79,109``),
  * sequence = concatenation of all sequence lines of the record,
  * AMR class = 4th ``|``-separated field of the id
    (``src/protein.rs:135-138``).

The port's own copy of the JAX package's ``io/fasta.py``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence

import numpy as np


@dataclasses.dataclass
class ProteinTable:
    """Column-oriented protein table.

    Attributes:
      ids: per-protein id strings (header first token), file order — the
        reference relies on file order for its 1-thread parity semantics
        (``SURVEY.md`` §3.2 nondeterminism note).
      seq_buf: uint8 concatenated residue bytes of every protein.
      offsets: int64 ``[N+1]``; protein n's residues are
        ``seq_buf[offsets[n]:offsets[n+1]]``.
      amr_classes: per-protein AMR class strings.
      amr_class_ids: int32 ``[N]`` dense class ids (first-appearance order).
      amr_class_names: id → class-name list.
    """

    ids: List[str]
    seq_buf: np.ndarray
    offsets: np.ndarray
    amr_classes: List[str]
    amr_class_ids: np.ndarray
    amr_class_names: List[str]

    @property
    def n(self) -> int:
        return len(self.ids)

    @property
    def lengths(self) -> np.ndarray:
        return np.diff(self.offsets).astype(np.int64)

    def seq(self, i: int) -> str:
        s, e = self.offsets[i], self.offsets[i + 1]
        return self.seq_buf[s:e].tobytes().decode("ascii")


def _amr_class(pid: str) -> str:
    """4th '|'-field of the protein id (src/protein.rs:135-138).

    The reference indexes ``protein_attr[3]`` unconditionally and would panic
    on malformed ids; we raise a ValueError with context instead.
    """
    parts = pid.split("|")
    if len(parts) < 4:
        raise ValueError(f"protein id {pid!r} lacks a 4th '|'-field (AMR class)")
    return parts[3]


def _dense_class_ids(classes: Sequence[str]) -> tuple[np.ndarray, List[str]]:
    table: Dict[str, int] = {}
    ids = np.empty(len(classes), dtype=np.int32)
    names: List[str] = []
    for i, c in enumerate(classes):
        if c not in table:
            table[c] = len(names)
            names.append(c)
        ids[i] = table[c]
    return ids, names


def parse_fasta_bytes(data: bytes) -> tuple[List[str], np.ndarray, np.ndarray]:
    """Parse FASTA bytes → (ids, seq_buf, offsets). Pure-numpy fast path."""
    ids: List[str] = []
    chunks: List[bytes] = []
    offsets = [0]
    total = 0
    cur: List[bytes] = []

    def flush():
        nonlocal total
        if not ids:
            return
        seq = b"".join(cur)
        chunks.append(seq)
        total += len(seq)
        offsets.append(total)
        cur.clear()

    for line in data.split(b"\n"):
        line = line.rstrip(b"\r")
        if not line:
            continue
        if line.startswith(b">"):
            flush()
            # id = first whitespace-delimited token after '>'
            tokens = line[1:].split(None, 1)
            if not tokens:
                raise ValueError(
                    f"FASTA header with no id (record {len(ids) + 1})"
                )
            ids.append(tokens[0].decode("ascii"))
        else:
            if not ids:
                raise ValueError("FASTA sequence data before first header")
            cur.append(line)
    flush()

    seq_buf = np.frombuffer(b"".join(chunks), dtype=np.uint8)
    return ids, seq_buf, np.asarray(offsets, dtype=np.int64)


def _read_file_bytes(path: str) -> bytes:
    """File bytes, transparently gunzipped (magic-sniffed, so a .gz
    extension is not required — UniProt corpora usually ship gzipped).
    The compressed stream is decompressed FROM DISK (gzip.open) so peak
    memory is the decompressed buffer alone, not compressed+decompressed."""
    with open(path, "rb") as f:
        magic = f.read(2)
    if magic == b"\x1f\x8b":
        import gzip

        with gzip.open(path, "rb") as f:
            return f.read()
    with open(path, "rb") as f:
        return f.read()


def read_fasta(path: str) -> ProteinTable:
    """Read a protein FASTA (plain or gzipped) into a ProteinTable.

    Uses the native C++ parser when the shared library has been built
    (``native/``), otherwise the numpy fallback — both produce identical
    tables (tested in ``tests/test_native.py``).
    """
    from uniprot_kmer_based_clustering_tpu_torch.io import native

    data = _read_file_bytes(path)
    # parse_fasta returns None when the library is unavailable (that is
    # the graceful-degradation case); real parse failures — including its
    # "malformed FASTA" ValueError — must propagate, not silently fall
    # back to a second full read on the numpy path
    parsed = native.parse_fasta(path, data=data)

    if parsed is not None:
        ids, seq_buf, offsets = parsed
    else:
        ids, seq_buf, offsets = parse_fasta_bytes(data)

    classes = [_amr_class(pid) for pid in ids]
    class_ids, class_names = _dense_class_ids(classes)
    return ProteinTable(
        ids=ids,
        seq_buf=seq_buf,
        offsets=offsets,
        amr_classes=classes,
        amr_class_ids=class_ids,
        amr_class_names=class_names,
    )
