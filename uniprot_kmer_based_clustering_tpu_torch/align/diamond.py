"""Host-side diamond blastp orchestration.

Reproduces ``Graph::align_and_output_pairs`` (src/graph/mod.rs:195-319):
for every surviving pair, write single-sequence reference/query FASTAs,
run ``diamond makedb`` + ``diamond blastp --outfmt 6 qseqid qlen sseqid
slen qstart qend sstart send length pident evalue bitscore``, concatenate
all stdout under one header row, and write ``blastp_output.tsv``.

Differences from the reference (deliberate):
  * scratch FASTA/db files live in a TemporaryDirectory instead of
    rm -rf'ing ./fasta_files and ./db_files in cwd (src/graph/mod.rs:202-220);
  * diamond failures surface per-pair instead of crashing the whole run
    (the reference ``expect()``s, src/graph/mod.rs:270,293);
  * pairs run through a bounded thread pool sized by os.cpu_count()
    (the reference runs one pair per OS thread, P9 in SURVEY.md §2.3).

The port's own copy of the JAX package's ``align/diamond.py``.
"""

from __future__ import annotations

import os
import shutil
import subprocess
import tempfile
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional

import numpy as np

from uniprot_kmer_based_clustering_tpu_torch.io.fasta import ProteinTable

TSV_HEADER = (
    "qseqid\tqlen\tsseqid\tslen\tqstart\tqend\tsstart\tsend\tlength\t"
    "pident\tevalue\tbitscore\n"
)
OUTFMT = (
    "qseqid qlen sseqid slen qstart qend sstart send length pident "
    "evalue bitscore"
).split()


def diamond_available() -> bool:
    return shutil.which("diamond") is not None


def _align_one(
    workdir: str, key: int, table: ProteinTable, i: int, j: int
) -> bytes:
    """makedb on protein i, blastp protein j against it — the reference
    uses edge vertex order (ref = vertices_key[0], query = [1]); with our
    canonical pairs that is ref = i (lower index), query = j."""
    ref_id = table.ids[i]
    qry_id = table.ids[j]
    # scratch paths keyed by (pair key, protein INDEX) — parsed accession
    # fields can collide (ids sharing their first '|'-field would map ref
    # and query to the SAME file, and makedb would silently index the
    # query: a self-alignment with no error)
    ref_fa = os.path.join(workdir, f"{key}_ref_{i}.fasta")
    qry_fa = os.path.join(workdir, f"{key}_qry_{j}.fasta")
    db = os.path.join(workdir, f"{key}_ref_{i}")
    with open(ref_fa, "w") as f:
        f.write(f">{ref_id}\n{table.seq(i)}\n")
    with open(qry_fa, "w") as f:
        f.write(f">{qry_id}\n{table.seq(j)}\n")
    subprocess.run(
        ["diamond", "makedb", "--in", ref_fa, "--db", db],
        check=True, capture_output=True,
    )
    out = subprocess.run(
        ["diamond", "blastp", "--db", db, "--query", qry_fa, "--outfmt", "6"]
        + OUTFMT,
        check=True, capture_output=True,
    )
    return out.stdout


def align_pairs(
    table: ProteinTable,
    pairs: np.ndarray,
    output_path: str = "blastp_output.tsv",
    max_workers: Optional[int] = None,
) -> str:
    """Align every pair and write the combined TSV. Returns the path.

    Raises RuntimeError when diamond is not installed (the capability is
    config-gated; see PipelineConfig.run_diamond).
    """
    if not diamond_available():
        raise RuntimeError(
            "diamond binary not found on PATH; install it (the reference "
            "uses a conda env, diamond.yaml) or disable run_diamond"
        )
    max_workers = max_workers or min(8, os.cpu_count() or 1)
    chunks: List[bytes] = [b""] * len(pairs)
    errors: List[str] = []
    with tempfile.TemporaryDirectory(prefix="ukc_diamond_") as workdir:
        def job(idx):
            i, j = int(pairs[idx][0]), int(pairs[idx][1])
            try:
                chunks[idx] = _align_one(workdir, idx, table, i, j)
            except subprocess.CalledProcessError as e:
                errors.append(
                    f"pair ({i},{j}): diamond rc={e.returncode}: "
                    f"{e.stderr.decode(errors='replace')[:200]}"
                )

        with ThreadPoolExecutor(max_workers=max_workers) as pool:
            list(pool.map(job, range(len(pairs))))

    if errors:
        # raise BEFORE writing: a complete-looking TSV with silently
        # missing rows is worse than no file (the checkpoint module's
        # tmp+replace discipline, applied here as fail-first)
        raise RuntimeError(
            f"{len(errors)} / {len(pairs)} alignments failed; first: "
            + errors[0]
        )
    tmp = output_path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(TSV_HEADER.encode())
        for c in chunks:
            f.write(c)
    os.replace(tmp, output_path)
    return output_path
