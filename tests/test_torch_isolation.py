"""The port stands alone: it imports neither jax nor the JAX package, and
its own copies of the host modules (config, io, kmers, utils) give what
the JAX package's give.

Inputs are seeded numpy arrays or the toy FASTA, handed to both packages.
Tolerance: exact equality (hashes, integer arrays, file contents).
"""

import ast
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

from uniprot_kmer_based_clustering_tpu import config as jconfig
from uniprot_kmer_based_clustering_tpu.io import fasta as jfasta
from uniprot_kmer_based_clustering_tpu.io import native as jnative
from uniprot_kmer_based_clustering_tpu.kmers import bitset as jbitset
from uniprot_kmer_based_clustering_tpu.kmers import encode as jencode
from uniprot_kmer_based_clustering_tpu.kmers import index as jindex
from uniprot_kmer_based_clustering_tpu.utils import blosum as jblosum
from uniprot_kmer_based_clustering_tpu.utils import checkpoint as jckpt
from uniprot_kmer_based_clustering_tpu_torch import config as tconfig
from uniprot_kmer_based_clustering_tpu_torch.io import fasta as tfasta
from uniprot_kmer_based_clustering_tpu_torch.io import native as tnative
from uniprot_kmer_based_clustering_tpu_torch.kmers import bitset as tbitset
from uniprot_kmer_based_clustering_tpu_torch.kmers import encode as tencode
from uniprot_kmer_based_clustering_tpu_torch.kmers import index as tindex
from uniprot_kmer_based_clustering_tpu_torch.utils import blosum as tblosum
from uniprot_kmer_based_clustering_tpu_torch.utils import checkpoint as tckpt

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = "uniprot_kmer_based_clustering_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "uniprot_kmer_based_clustering_tpu")
# the repository's bench scripts import the JAX package
ROOT_SCRIPTS = tuple(sorted(f[:-3] for f in os.listdir(REPO)
                            if f.startswith("bench") and f.endswith(".py")))


def _port_files():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(REPO, PORT)):
        files += [os.path.join(root, f) for f in names if f.endswith(".py")]
    return sorted(files)


def _imported_modules(path):
    """Every module name an import statement of the file names."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module)
    return names


@pytest.mark.parametrize(
    "path", _port_files(), ids=lambda p: os.path.relpath(p, REPO))
def test_no_file_of_the_port_imports_jax_or_the_jax_package(path):
    bad = [m for m in _imported_modules(path)
           if m.split(".")[0] in FORBIDDEN + ROOT_SCRIPTS]
    assert bad == []


def test_cli_run_loads_neither_jax_nor_the_jax_package(toy_fasta, tmp_path):
    """A fresh interpreter runs the port's `cli run --device cpu`; neither
    name reaches sys.modules."""
    code = (
        "import sys\n"
        f"from {PORT}.cli import main\n"
        "assert main(['run', sys.argv[1], '--device', 'cpu', '--out', "
        "sys.argv[2]]) == 0\n"
        f"bad = [m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r}]\n"
        "assert not bad, bad\n"
        "print('ISOLATED_OK')\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code, toy_fasta, str(tmp_path / "out")],
        cwd=REPO, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    assert "ISOLATED_OK" in proc.stdout
    assert (tmp_path / "out" / "pairs.tsv").exists()


@pytest.mark.parametrize("argv", [
    ["query", "{fasta}", "--device", "cpu", "--seq",
     "MKTAYIAKQRQISFVKSHFSRQLEERLGLIEVQ"],
    ["run", "{fasta}", "--device", "cpu", "--index-engine", "device",
     "--out", "{out}"],
    ["run", "{fasta}", "--device", "cpu", "--threshold", "2", "--align",
     "sw", "--cluster", "agglomerative", "--out", "{out}"],
    ["run", "{fasta}", "--device", "cpu", "--align", "diamond", "--cluster",
     "tree", "--out", "{out}"],
    ["run", "{fasta}", "--device", "cpu", "--threshold", "0", "--dump-kmers",
     "--dump-proteins", "--dump-debug", "--out", "{out}"],
], ids=["query", "run-device-index", "run-align-agglomerative",
        "run-diamond-fallback-tree", "run-dumps"])
def test_query_and_device_index_load_neither_jax_nor_the_jax_package(
        toy_fasta, tmp_path, argv):
    """The serving path (`cli query`, QueryServer, kmers.append), the
    device index build, alignment, tree and agglomerative clustering and
    the dumps in a fresh interpreter: neither name reaches
    sys.modules."""
    code = (
        "import sys, json\n"
        f"from {PORT}.cli import main\n"
        f"from {PORT}.similarity import QueryServer\n"
        f"from {PORT}.kmers import append, index_device\n"
        f"from {PORT} import align, models\n"
        "assert main(json.loads(sys.argv[1])) == 0\n"
        f"bad = [m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r}]\n"
        "assert not bad, bad\n"
        "print('ISOLATED_OK')\n"
    )
    import json

    argv = [a.format(fasta=toy_fasta, out=str(tmp_path / "out"))
            for a in argv]
    proc = subprocess.run(
        [sys.executable, "-c", code, json.dumps(argv)],
        cwd=REPO, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    assert "ISOLATED_OK" in proc.stdout


CONFIGS = [
    {},
    dict(k=7),
    dict(weighting="blosum62"),
    dict(weighting="blosum62", weighted_threshold=250, threshold=7),
    dict(engine="popcount", cross_amr_only=False, threshold=0),
    dict(sampling="random10", seed=3, cluster="none", tile=128, strip=256),
]


@pytest.mark.parametrize("kw", CONFIGS, ids=lambda kw: str(kw) or "default")
@pytest.mark.parametrize("stage", ["index", "pairs", "clusters"])
def test_cache_keys_are_the_jax_packages(kw, stage):
    j, t = jconfig.PipelineConfig(**kw), tconfig.PipelineConfig(**kw)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert t.cache_key(stage, "f:1:2") == j.cache_key(stage, "f:1:2")
    wts = np.array([0, 25, 30, 41], np.int8)
    assert (t.effective_weighted_threshold(wts)
            == j.effective_weighted_threshold(wts))


def test_config_refuses_what_the_jax_config_refuses():
    for kw in (dict(k=6), dict(tile=12), dict(engine="gpu"),
               dict(stream_source="csr")):
        with pytest.raises(ValueError) as jerr:
            jconfig.PipelineConfig(**kw)
        with pytest.raises(ValueError) as terr:
            tconfig.PipelineConfig(**kw)
        assert str(terr.value) == str(jerr.value)


def _random_proteins(seed, n=120):
    rng = np.random.default_rng(seed)
    aas = np.frombuffer(b"CSTAGPDEQNHRKMILVWYFXB", np.uint8)
    templates = [aas[rng.integers(0, 22, int(m))] for m in
                 rng.integers(30, 90, 5)]
    seqs = []
    for i in range(n):
        s = templates[i % 5].copy()
        s[rng.integers(0, len(s), 4)] = aas[rng.integers(0, 22, 4)]
        seqs.append(s[: len(s) - int(rng.integers(0, 10))])
    seq_buf = np.concatenate(seqs)
    offsets = np.zeros(n + 1, np.int64)
    np.cumsum([len(s) for s in seqs], out=offsets[1:])
    return seq_buf, offsets


def test_read_fasta_is_the_jax_packages(toy_fasta):
    j, t = jfasta.read_fasta(toy_fasta), tfasta.read_fasta(toy_fasta)
    assert t.ids == j.ids and t.amr_classes == j.amr_classes
    assert t.amr_class_names == j.amr_class_names
    for f in ("seq_buf", "offsets", "amr_class_ids"):
        assert np.array_equal(getattr(t, f), getattr(j, f))
    with open(toy_fasta, "rb") as f:
        data = f.read()
    for a, b in zip(tfasta.parse_fasta_bytes(data),
                    jfasta.parse_fasta_bytes(data)):
        assert np.array_equal(np.asarray(a), np.asarray(b))


def _check_encode_and_index(engine, k, sampling):
    """The port's encode and index against the JAX package's. With
    ``engine="auto"`` the port builds its index with its own C++ runtime;
    the JAX package builds with its C++ runtime where that one loaded in
    this process, else with numpy (its own tests pin native = numpy), so
    the port's native build is held to an oracle either way."""
    seq_buf, offsets = _random_proteins(k + len(sampling))
    jc, jo = jencode.encode_kmers(seq_buf, offsets, k, sampling=sampling,
                                  seed=5, engine=engine)
    tc, to = tencode.encode_kmers(seq_buf, offsets, k, sampling=sampling,
                                  seed=5, engine=engine)
    assert np.array_equal(tc, jc) and np.array_equal(to, jo)
    build = "native" if engine == "auto" else "numpy"
    jbuild = build if jnative.available() else "numpy"
    ji = jindex.build_index(jc, jo, k, engine=jbuild)
    ti = tindex.build_index(tc, to, k, engine=build)
    assert ti.n_repeated > 0
    for f in dataclasses.fields(jindex.KmerIndex):
        a, b = getattr(ti, f.name), getattr(ji, f.name)
        assert np.array_equal(np.asarray(a), np.asarray(b)), f.name
    assert ti.multigraph_edge_count() == ji.multigraph_edge_count()


@pytest.mark.parametrize("engine", ["auto", "numpy"])
@pytest.mark.parametrize("k,sampling", [(5, "all"), (7, "all"),
                                        (5, "random10")])
def test_encode_and_index_are_the_jax_packages(engine, k, sampling):
    _check_encode_and_index(engine, k, sampling)


@pytest.mark.parametrize("k,sampling", [(5, "all"), (7, "all"),
                                        (5, "random10")])
def test_encode_and_index_hold_without_the_jax_native_runtime(
        monkeypatch, k, sampling):
    """The JAX package's C++ runtime can fail to load in a test worker
    (it is built in place by every process): the port's native-built
    index is then held against the JAX package's numpy build."""
    monkeypatch.setattr(jnative, "_load", lambda: None)
    assert not jnative.available()
    with pytest.raises(RuntimeError, match="native index builder"):
        jindex.build_index(np.zeros(0, np.int64), np.zeros(1, np.int64), k,
                           engine="native")
    _check_encode_and_index("auto", k, sampling)


@pytest.mark.parametrize("row_multiple", [128, 512])
def test_pack_bitsets_and_blosum_weights_are_the_jax_packages(row_multiple):
    seq_buf, offsets = _random_proteins(11)
    codes, koff = tencode.encode_kmers(seq_buf, offsets, 5)
    idx = tindex.build_index(codes, koff, 5)
    args = (idx.incidence_protein, idx.incidence_rank, 120, idx.n_repeated)
    j = jbitset.pack_bitsets(*args, row_multiple=row_multiple)
    t = tbitset.pack_bitsets(*args, row_multiple=row_multiple)
    assert (t.n, t.n_bits, t.n_pad, t.w_pad) == (j.n, j.n_bits, j.n_pad,
                                                 j.w_pad)
    assert t.words.dtype == np.uint32 and np.array_equal(t.words, j.words)
    assert np.array_equal(t.row_bits(3), j.row_bits(3))
    want = jblosum.rank_weights_int8(idx.repeated_codes, 5, j.w_pad * 32)
    got = tblosum.rank_weights_int8(idx.repeated_codes, 5, t.w_pad * 32)
    assert got.dtype == np.int8 and np.array_equal(got, want)


@pytest.mark.parametrize("writer", ["jax", "torch", "torch-uncompressed"])
def test_checkpoint_files_cross_packages(tmp_path, writer):
    rng = np.random.default_rng(2)
    arrays = dict(pairs=rng.integers(0, 99, (7, 3)).astype(np.int32),
                  stats=rng.integers(-5, 5, 8).astype(np.int64))
    stores = {"jax": jckpt.CheckpointStore(str(tmp_path)),
              "torch": tckpt.CheckpointStore(str(tmp_path))}
    if writer == "torch-uncompressed":
        stores["torch"].save("k1", compressed=False, **arrays)
    else:
        stores[writer].save("k1", **arrays)
    reader = stores["jax" if writer.startswith("torch") else "torch"]
    got = reader.load("k1")
    assert set(got) == set(arrays)
    for name, a in arrays.items():
        assert got[name].dtype == a.dtype and np.array_equal(got[name], a)
    assert sorted(os.listdir(tmp_path)) == ["k1.npz"]


def test_native_library_builds_into_the_port(tmp_path, monkeypatch):
    """The C++ runtime builds with g++ into the port's build directory,
    named by a hash of the source, through a private file moved into
    place: nothing else is left behind, and an edited source is a new
    library."""
    if not tnative.available():
        pytest.skip("no C++ compiler")
    path = tnative.library_path()
    assert os.path.dirname(path) == os.path.join(REPO, PORT, "build")
    assert os.path.exists(path)
    src = tmp_path / "ukc_native.cpp"
    src.write_bytes(open(tnative.SOURCE, "rb").read())
    monkeypatch.setattr(tnative, "SOURCE", str(src))
    monkeypatch.setattr(tnative, "BUILD_DIR", str(tmp_path / "build"))
    so = tnative.library_path()
    assert os.path.basename(so) == os.path.basename(path)
    tnative._build(so)
    assert os.listdir(tmp_path / "build") == [os.path.basename(so)]
    src.write_text(src.read_text() + "\n// edited\n")
    assert tnative.library_path() != so
