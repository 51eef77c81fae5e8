"""The benchmark's corpus: families of near-identical proteins, drawn
from a seed, shaped after the statistics of the upstream's
``uniprot_arg.fasta``.

The configuration's ``corpus`` block fixes the shape, and the seed never
changes it: how many proteins each AMR class holds; the families given
whole (``fixed_families``: their classes, members and length), which
hold the shortest and the longest protein and the only cross-class pairs
over the threshold; how the other proteins of each class fall into
families (a Zipf law of family sizes); their lengths (a log-normal in
protein space: the families, in an order drawn from ``shape_seed``, take
successive bands of the proteins, and each the quantile at its band's
middle); how many residues each member has substituted; and the order
of the proteins in the file, drawn from ``shape_seed`` too, so that the
tiles holding cross-class pairs are the same for every seed. The seed
draws the rest: each family's template residues (from the block's
amino-acid composition) and the substituted positions and residues of
each member. So every seed gives the same lengths, family sizes,
substitution counts and classes at the same places in the file, and the
same work; only the residues differ.
"""

from __future__ import annotations

from statistics import NormalDist

import numpy as np

AMINO_ACIDS = np.frombuffer(b"CSTAGPDEQNHRKMILVWYF", np.uint8)


def _zipf_sizes(total: int, families: int, exponent: float) -> list:
    """``families`` sizes summing to ``total``, each at least 1, in
    proportion to ``k ** -exponent``; what rounding leaves over goes to
    the largest."""
    families = max(1, min(families, total))
    w = np.arange(1, families + 1, dtype=np.float64) ** -exponent
    sizes = np.maximum(1, np.floor(total * w / w.sum())).astype(np.int64)
    while sizes.sum() > total:
        sizes[np.argmax(sizes)] -= 1
    sizes[0] += total - sizes.sum()
    return [int(s) for s in sizes]


def corpus_shape(spec: dict):
    """The seed-free shape of the corpus: (a list of families, each
    ``(length, member classes int32 [size])``; the order of the proteins,
    the file's i-th protein being member ``order[i]`` when the families'
    members are counted one after another)."""
    class_sizes = [int(c) for c in spec["class_sizes"]]
    if sum(class_sizes) != int(spec["n"]):
        raise ValueError(f"class_sizes sum to {sum(class_sizes)}, "
                         f"not n = {spec['n']}")
    left = list(class_sizes)
    fixed = []
    for fam in spec.get("fixed_families", []):
        members = []
        for c, m in zip(fam["classes"], fam["members"]):
            left[c] -= int(m)
            members += [c] * int(m)
        if min(left) < 0:
            raise ValueError("fixed_families take more members than a "
                             "class has")
        fixed.append((int(fam["length"]), np.array(members, np.int32)))
    per_family = float(spec["proteins_per_family"])
    plain = []
    for c, r in enumerate(left):
        if r:
            for s in _zipf_sizes(r, round(r / per_family),
                                 float(spec["family_exponent"])):
                plain.append(np.full(s, c, np.int32))
    shape_rng = np.random.default_rng(int(spec["shape_seed"]))
    plain = [plain[i] for i in shape_rng.permutation(len(plain))]
    sizes = np.array([len(m) for m in plain], np.float64)
    middle = (np.cumsum(sizes) - sizes / 2) / sizes.sum()
    dist = NormalDist(np.log(float(spec["length_median"])),
                      float(spec["length_sigma"]))
    lengths = np.clip(np.rint(np.exp([dist.inv_cdf(q) for q in middle])),
                      int(spec["length_min"]), int(spec["length_max"]))
    return ([(int(n), m) for n, m in zip(lengths, plain)] + fixed,
            shape_rng.permutation(int(spec["n"])))


def synth_proteins(spec: dict, seed: int):
    """``(seq_buf uint8, offsets int64 [n+1], classes int32 [n])`` for the
    configuration's ``corpus`` block ``spec`` and ``seed``: each member a
    copy of its family's template with ``round(length *
    substitutions_per_residue)`` residues replaced by another."""
    rng = np.random.default_rng(int(seed))
    comp = np.array([spec["composition"][chr(a)] for a in AMINO_ACIDS],
                    np.float64)
    comp /= comp.sum()
    rate = float(spec["substitutions_per_residue"])
    seqs, classes = [], []
    families, order = corpus_shape(spec)
    for length, members in families:
        template = rng.choice(20, length, p=comp).astype(np.uint8)
        n_sub = int(round(length * rate))
        for c in members:
            s = template.copy()
            if n_sub:
                pos = rng.integers(0, length, n_sub)
                s[pos] = (s[pos] + rng.integers(1, 20, n_sub)) % 20
            seqs.append(AMINO_ACIDS[s])
            classes.append(c)
    seqs = [seqs[i] for i in order]
    offsets = np.zeros(len(seqs) + 1, np.int64)
    np.cumsum([len(s) for s in seqs], out=offsets[1:])
    return (np.concatenate(seqs), offsets,
            np.asarray(classes, np.int32)[order])


def write_fasta(path: str, seq_buf, offsets, classes) -> None:
    """The corpus as a FASTA file with the upstream's id layout
    ``>ID|FEATURES|UNIPROT|<class>|gene``, whose 4th field is the AMR
    class."""
    lines = []
    for i in range(len(classes)):
        seq = seq_buf[offsets[i] : offsets[i + 1]].tobytes().decode()
        lines.append(f">SYN{i:06d}|FEATURES|UNIPROT|class{classes[i]}|"
                     f"gene{i}\n{seq}\n")
    with open(path, "w") as f:
        f.write("".join(lines))
