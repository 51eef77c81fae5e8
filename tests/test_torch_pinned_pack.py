"""Packing into a caller's buffer, the rule that pins host words, and the
counters of the bytes sent from page-locked memory, on the CPU.

Words bound for a CUDA device are packed into page-locked memory
(``kmers.bitset.pinned_words``), so that the sweep's upload and the
mesh's staging are DMAs; those paths run on the card
(``tests/test_torch_gpu.py``). Here: a pack into a buffer that held
other bytes gives the words of a fresh pack, with the native packer and
with the numpy fallback; the pin rule takes only CUDA devices and sizes
up to a quarter of the host's memory, and never allocates otherwise; and
a CPU run keeps plain numpy words, sends nothing from page-locked memory
(``pinned_bytes``, ``stage_pinned_bytes`` 0) and gives the plain
reference's pairs, on one device and on a two-shard ring.
"""

import importlib.util
import json
import os

import numpy as np
import pytest
import torch

from uniprot_kmer_based_clustering_tpu_torch.config import PipelineConfig
from uniprot_kmer_based_clustering_tpu_torch.io import native
from uniprot_kmer_based_clustering_tpu_torch.kmers import bitset as tbitset
from uniprot_kmer_based_clustering_tpu_torch.parallel import sharded as tsh
from uniprot_kmer_based_clustering_tpu_torch.parallel.mesh import make_mesh
from uniprot_kmer_based_clustering_tpu_torch.pipeline import (
    _sharded_similarity,
    run_pipeline,
)
from uniprot_kmer_based_clustering_tpu_torch.similarity import pairwise as tpw
from uniprot_kmer_based_clustering_tpu_torch.state import bitset_to_torch

BENCH = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "benchmark")
SEED = 2**31 + 25
# the benchmark's configuration at 300 proteins, as the ring tracing
# tests cut it: one family of two classes, so that pairs pass the
# threshold; tile 1,024 pads the rows to 1,024, two 512-row ring blocks
SMALL = {"n": 300,
         "class_sizes": [112, 100, 24, 24, 17, 11, 6, 5, 1],
         "fixed_families": [{"classes": [7, 2], "members": [2, 8],
                             "length": 300}],
         "proteins_per_family": 6}
TILE = 1024


def _load(name, *path):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(BENCH, *path))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


bench_corpus = _load("bench_corpus", "corpus.py")
kmer_pairs = _load("bench_kmer_pairs", "reference", "kmer_pairs.py")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def incidences():
    """(protein, rank) incidences of 700 proteins over 5,000 ranks: rows
    with no incidence, and protein 660 alone past row 650, with two ranks
    in one word and bit 31 of the next."""
    rng = np.random.default_rng(25)
    m = 40_000
    prot = rng.integers(0, 650, m).astype(np.int32)
    rank = rng.integers(0, 5_000, m).astype(np.int32)
    prot[:3], rank[:3] = 660, [31, 30, 63]
    return prot, rank, 700, 5_000


@pytest.fixture
def packer(request, monkeypatch):
    if request.param == "native":
        if not native.available():
            pytest.skip("the native runtime did not build")
    else:
        monkeypatch.setattr(native, "_load", lambda: None)
    return request.param


@pytest.mark.parametrize("fill", [-1, 0x5A5A5A5A])
@pytest.mark.parametrize("packer", ["native", "numpy"], indirect=True)
def test_pack_into_a_dirty_buffer_equals_a_fresh_pack(incidences, packer,
                                                      fill):
    prot, rank, n, n_bits = incidences
    fresh = tbitset.pack_bitsets(prot, rank, n, n_bits, row_multiple=256)
    shape = tbitset.padded_shape(n, n_bits, row_multiple=256)
    assert fresh.words.shape == shape == (768, 256)
    out = torch.full(shape, fill, dtype=torch.int32)  # left by a user
    got = tbitset.pack_bitsets(prot, rank, n, n_bits, row_multiple=256,
                               out=out)
    assert got.words.dtype == np.uint32
    assert np.array_equal(got.words, fresh.words)
    assert np.shares_memory(got.words, out.numpy())
    # a CPU buffer is not page-locked, and neither pack is
    assert got.pinned is None and fresh.pinned is None
    rest = np.delete(fresh.words[650:], 660 - 650, axis=0)
    assert int(np.count_nonzero(rest)) == 0
    assert fresh.words[660, :2].tolist() == [0xC0000000, 0x80000000]


@pytest.mark.parametrize("out", [
    torch.zeros((768, 255), dtype=torch.int32),
    torch.zeros((768, 256), dtype=torch.int64),
    torch.zeros((256, 768), dtype=torch.int32).t(),
])
def test_pack_refuses_a_buffer_of_another_shape(incidences, out):
    prot, rank, n, n_bits = incidences
    with pytest.raises(ValueError, match="out must be"):
        tbitset.pack_bitsets(prot, rank, n, n_bits, row_multiple=256,
                             out=out)


def _cap() -> int:
    return os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES") // 4


def _top_block() -> int:
    """The largest power of two within the cap: the largest block the
    caching host allocator may hand out for pinned words."""
    return 1 << (_cap().bit_length() - 1)


@pytest.mark.parametrize("size", ["small", "odd", "at_cap", "over_cap"])
@pytest.mark.parametrize("device", ["cpu", "cuda", "cuda:1"])
def test_pin_rule_takes_cuda_devices_up_to_a_quarter_of_the_host(device,
                                                                 size):
    nbytes = {"small": 4096, "odd": 313_786_368, "at_cap": _top_block(),
              "over_cap": _top_block() + 4}[size]
    want = device.startswith("cuda") and size != "over_cap"
    assert tbitset.wants_pinned(device, nbytes) is want
    assert tbitset.wants_pinned(torch.device(device), nbytes) is want


@pytest.mark.parametrize("device,rows", [
    ("cpu", 1024),
    ("cuda", _top_block() // 4096 + 1),  # a block of twice the largest
])
def test_pinned_words_allocates_nothing_the_rule_refuses(monkeypatch,
                                                         device, rows):
    def refuse(*args, **kwargs):
        raise AssertionError("allocated")

    monkeypatch.setattr(torch, "empty", refuse)
    assert tbitset.pinned_words((rows, 1024), device) is None


def test_pinned_words_falls_back_when_the_allocation_fails(monkeypatch):
    calls = []

    def fail(*args, **kwargs):
        calls.append(kwargs)
        raise RuntimeError("cudaHostAlloc failed")

    monkeypatch.setattr(torch, "empty", fail)
    assert tbitset.pinned_words((512, 128), "cuda") is None
    assert calls == [{"dtype": torch.int32, "pin_memory": True}]


def test_the_upload_copies_from_the_owning_tensor():
    """A bitset that carries its owning tensor is sent from that tensor,
    not from a numpy view of it (on the CPU the result is the tensor
    itself)."""
    owner = torch.arange(512 * 128, dtype=torch.int32).view(512, 128)
    bs = tbitset.BitsetMatrix(words=owner.numpy().view(np.uint32), n=500,
                              n_bits=4000, pinned=owner)
    assert bitset_to_torch(bs, "cpu") is owner
    plain = tbitset.BitsetMatrix(words=owner.numpy().view(np.uint32), n=500,
                                 n_bits=4000)
    assert torch.equal(bitset_to_torch(plain, "cpu"), owner)


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    """(pipeline config, the packed corpus, the reference's answer)."""
    with open(os.path.join(BENCH, "configs", "arg_k5_n10619.json")) as f:
        bench = json.load(f)
    spec = {**bench["corpus"], **SMALL}
    seq_buf, offsets, classes = bench_corpus.synth_proteins(spec, SEED)
    fasta = str(tmp_path_factory.mktemp("pinned") / "corpus.fasta")
    bench_corpus.write_fasta(fasta, seq_buf, offsets, classes)
    config = PipelineConfig(**{**bench["pipeline"], "engine": "mxu",
                               "tile": TILE})
    pre = run_pipeline(fasta, config, stop_after="pack", device="cpu")
    ref = kmer_pairs.answer(seq_buf, offsets, classes, k=config.k,
                            threshold=config.threshold,
                            cross_amr_only=config.cross_amr_only,
                            with_components=False)
    assert len(ref["pairs"]) > 0
    return config, pre, ref


def test_a_cpu_pipeline_keeps_plain_numpy_words(job):
    _, pre, _ = job
    words = pre.bitset.words
    assert pre.bitset.pinned is None
    assert type(words) is np.ndarray and words.dtype == np.uint32
    assert words.base is None and words.flags.owndata


@pytest.mark.parametrize("source", ["pipeline", "dirty_buffer"])
def test_cpu_sweep_sends_nothing_pinned(job, source):
    config, pre, ref = job
    bitset = pre.bitset
    if source == "dirty_buffer":
        bitset = tbitset.pack_bitsets(
            pre.index.incidence_protein, pre.index.incidence_rank,
            bitset.n, bitset.n_bits, row_multiple=TILE,
            out=torch.full(bitset.words.shape, -1, dtype=torch.int32))
        assert np.array_equal(bitset.words, pre.bitset.words)
    r = tpw.pairwise_similarity(bitset, pre.table.amr_class_ids, config,
                                index=pre.index, device="cpu")
    t = tpw.last_trace
    assert t["pinned_bytes"] == 0
    assert t["upload_bytes"] == bitset.words.nbytes + bitset.n_pad * 4
    assert np.array_equal(np.asarray(r.pairs, np.int64), ref["pairs"])


@pytest.mark.parametrize("words", ["numpy", "tensor"])
def test_cpu_ring_stages_nothing_pinned(job, words):
    config, pre, ref = job
    mesh = make_mesh(2, device="cpu")
    if words == "numpy":
        r = _sharded_similarity(pre.bitset, pre.table, config, mesh,
                                index=pre.index)
        assert np.array_equal(np.asarray(r.pairs, np.int64), ref["pairs"])
        t = tsh.last_trace
    else:
        t = tsh.new_trace()
        classes = np.full(pre.bitset.n_pad, -1, np.int32)
        classes[: pre.bitset.n] = pre.table.amr_class_ids
        tsh.stage_mesh_inputs(
            mesh, torch.from_numpy(pre.bitset.words.view(np.int32)),
            classes, t)
    n_pad, w_pad = pre.bitset.n_pad, pre.bitset.w_pad
    assert t["stage_bytes"] == n_pad * w_pad * 4 + n_pad * 4
    assert t["stage_pinned_bytes"] == 0
