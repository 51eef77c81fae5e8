"""Pipeline configuration.

The reference hardcodes every knob (dataset size 10,619 at
``src/main.rs:96``; alignment threshold 10 at ``src/graph/mod.rs:242``;
k=5 in the live path, k∈{5,7} in the tree path ``src/tree.rs:89-105``;
random-10% sampling in the dead ``Protein::new_with_rand_fivemers`` at
``src/protein.rs:77-104``). Here they are all first-class config.

The port's own copy of the JAX package's ``config.py``: every field,
default and ``cache_key`` is the same, so checkpoints cross between the
packages. Knobs the port does not carry yet are refused where they are
read (``pipeline.run_pipeline``, the CLI).
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
from typing import Optional


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """Configuration for the full clustering pipeline."""

    # --- k-mer extraction (reference src/protein.rs) ---
    k: int = 5                      # k-mer size; 5 (live path) or 7 (tree path)
    sampling: str = "all"           # "all" | "random10" (src/protein.rs:77-104)
    seed: int = 0                   # RNG seed for the random10 sampling mode

    # --- similarity / graph (reference src/graph/mod.rs) ---
    threshold: int = 10             # align pairs with shared k-mers > threshold
                                    # (src/graph/mod.rs:242)
    cross_amr_only: bool = True     # keep only pairs whose AMR classes differ
                                    # (src/graph/mod.rs:580-587)
    weighting: str = "none"         # "none" | "blosum62" (src/blosum.rs variant)
    weighted_threshold: Optional[int] = None  # threshold on the weighted score
                                              # (defaults to `threshold` when
                                              # weighting is enabled and this
                                              # field is None)

    # --- device execution ---
    engine: str = "auto"            # "auto" | "mxu" | "popcount" | "xla"
                                    #   | "native" | "stream"
                                    #   mxu: int8 binary-matmul sweep (fastest)
                                    #   popcount: packed-bitset Pallas kernel
                                    #     (8× less HBM; memory-lean at scale)
                                    #   xla: popcount fallback, runs anywhere
                                    #   native: threaded C++ host sweep (the
                                    #     fast no-accelerator path)
                                    #   stream: out-of-core MXU sweep — the
                                    #     packed matrix stays in host RAM and
                                    #     row blocks stream through the device
                                    #     (corpora beyond one chip's HBM)
                                    #   auto: mxu on TPU; native on the cpu
                                    #     platform when built; xla otherwise
                                    #     (GPUs keep the device engine)
    tile: int = 512                 # protein-axis tile for the pairwise sweep
    strip: Optional[int] = None     # stationary strip rows for the MXU engine
                                    # (None = auto: one full-square call when
                                    # the counts matrix fits HBM, else strips)
    word_block: int = 512           # k-mer-word-axis block inside the kernel
    extract: str = "auto"           # "auto" | "two_pass" | "fused" |
                                    #   "onepass": pair
                                    #   recovery strategy for the MXU engine.
                                    #   two_pass recomputes only the tiles
                                    #   that reported hits (optimal in the
                                    #   sparse-hit regime — the bundled
                                    #   dataset); fused compacts survivors
                                    #   inside the scan-schedule sweep itself
                                    #   (optimal for dense-homology corpora
                                    #   where most tiles hit) and, on a
                                    #   mesh, fuses stats+extract into ONE
                                    #   pass on every layout (halves the
                                    #   matmuls and collectives); onepass
                                    #   (stream engine only) compacts
                                    #   survivors into device pair buffers
                                    #   during the streamed sweep itself —
                                    #   no candidate-capacity guessing, no
                                    #   per-step drain volume; auto
                                    #   currently = two_pass. Bit-identical
                                    #   outputs.
    extract_k: int = 0              # extraction capacity knob; the meaning
                                    #   depends on `extract` (the two differ
                                    #   by orders of magnitude — don't carry
                                    #   a fused-tuned value into onepass):
                                    #   fused: PER-SUB-TILE candidate
                                    #     capacity (top-k per sweep step;
                                    #     typical 512-4096);
                                    #   onepass: TOTAL device pair-buffer
                                    #     rows for the whole sweep, rounded
                                    #     to 128 (typical millions).
                                    #   0 = auto-size from the HBM budget
                                    #   in both modes; capacity misses are
                                    #   detected exactly and redone.
    stream_source: str = "host"     # stream-engine block source:
                                    #   "host": row blocks upload from the
                                    #     host-resident packed matrix (the
                                    #     right source on PCIe-class hosts);
                                    #   "csr": blocks MATERIALIZE on device
                                    #     from the sparse incidence lists
                                    #     (uploaded once, ~0.02% of the
                                    #     dense volume at beyond-HBM scale)
                                    #     — the fix when host→device
                                    #     bandwidth is the bottleneck.
                                    #     Requires the host-built index
                                    #     and extract='onepass'.
    index_engine: str = "host"      # "host" | "device": where the doc-freq
                                    # index + bitset are built. "device"
                                    # runs on TPU — k=5: dense-universe
                                    # bincount/rank/scatter (distributes
                                    # via psum); k=7: global-sort build.
                                    # Bit-identical to host either way.

    # --- clustering (reference src/tree.rs) ---
    cluster: str = "components"     # "components" | "tree" |
                                    # "agglomerative" (batched MXU
                                    # mutual-argmax merges) | "none"
    min_shared: int = 1             # agglomerative merge gate: minimum
                                    # shared k-mers between cluster
                                    # intersection signatures (tree.rs
                                    # balance() uses "any" = 1)

    # --- alignment backend (reference src/graph/mod.rs:195-319) ---
    run_diamond: bool = False       # shell out to diamond when available

    def __post_init__(self):
        if self.k not in (5, 7):
            # src/tree.rs:103-105 panics with the same constraint.
            raise ValueError(f"k must be 5 or 7, got {self.k}")
        if self.sampling not in ("all", "random10"):
            raise ValueError(f"unknown sampling mode {self.sampling!r}")
        if self.weighting not in ("none", "blosum62"):
            raise ValueError(f"unknown weighting mode {self.weighting!r}")
        if self.cluster not in ("components", "tree", "agglomerative", "none"):
            raise ValueError(f"unknown cluster mode {self.cluster!r}")
        if self.engine not in (
            "auto", "mxu", "popcount", "xla", "native", "stream"
        ):
            raise ValueError(f"unknown engine {self.engine!r}")
        if self.index_engine not in ("host", "device"):
            raise ValueError(f"unknown index_engine {self.index_engine!r}")
        if self.stream_source not in ("host", "csr"):
            raise ValueError(
                f"unknown stream_source {self.stream_source!r}"
            )
        if self.stream_source == "csr" and self.extract not in (
            "auto", "onepass"
        ):
            raise ValueError(
                "stream_source='csr' pairs with extract='onepass' (the "
                "window/fused extractors read host rows directly)"
            )
        if self.stream_source == "csr" and self.engine != "stream":
            raise ValueError(
                "stream_source='csr' is a stream-engine knob; it would "
                "be silently ignored with engine="
                f"{self.engine!r} — set engine='stream'"
            )
        if self.extract not in ("auto", "two_pass", "fused", "onepass"):
            raise ValueError(f"unknown extract mode {self.extract!r}")
        if self.extract_k < 0:
            raise ValueError("extract_k must be >= 0")
        if self.strip is not None and self.strip % self.tile != 0:
            raise ValueError("strip must be a multiple of tile")
        if self.tile % 8 != 0:
            raise ValueError("tile must be a multiple of 8 (TPU sublane)")
        if self.word_block % 128 != 0:
            raise ValueError("word_block must be a multiple of 128 (TPU lane)")

    def effective_weighted_threshold(self, weights=None) -> int:
        """Alignment gate for weighted scores.

        With no explicit ``weighted_threshold``, the raw-count gate is
        scaled by the mean positive per-k-mer weight so the weighted run
        passes "more than ~`threshold` average k-mers' worth" of weighted
        evidence — applying the raw gate (10) directly to BLOSUM scores
        (mean self-score ≈ 27 per 5-mer) would pass every pair sharing a
        single k-mer.
        """
        if self.weighted_threshold is not None:
            return self.weighted_threshold
        if weights is None:
            return self.threshold
        import numpy as np

        pos = np.asarray(weights)
        pos = pos[pos > 0]
        if pos.size == 0:
            return self.threshold
        return int(self.threshold * int(round(float(pos.mean()))))

    # Which config fields each checkpointed stage's artifact actually
    # depends on. Engines are deliberately absent: all sweep engines and
    # mesh shapes produce bit-identical artifacts (the core invariant),
    # so a resumed run may switch engine/devices freely; cluster-only
    # knobs must not invalidate the expensive index/pairs artifacts.
    _STAGE_FIELDS = {
        "index": ("k", "sampling", "seed"),
        "pairs": (
            "k", "sampling", "seed",
            "threshold", "weighted_threshold", "cross_amr_only",
            "weighting",
        ),
    }

    def cache_key(self, stage: str, extra: str = "") -> str:
        """Stable hash identifying a stage's artifact for checkpoint/resume."""
        cfg = dataclasses.asdict(self)
        fields = self._STAGE_FIELDS.get(stage)
        if fields is not None:
            cfg = {k: cfg[k] for k in fields}
        payload = json.dumps(
            {"stage": stage, "extra": extra, **cfg}, sort_keys=True
        )
        return hashlib.sha256(payload.encode()).hexdigest()[:16]
