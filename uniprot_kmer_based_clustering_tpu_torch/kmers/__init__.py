"""k-mer encoding, the doc-freq index, the packed presence bitsets and
corpus appends (host numpy / C++), and the device index build (torch)."""

from uniprot_kmer_based_clustering_tpu_torch.kmers.encode import (  # noqa: F401
    AMINO_ACIDS,
    decode_kmer,
    encode_kmers,
    encode_kmers_device,
    residues_to_indices,
)
from uniprot_kmer_based_clustering_tpu_torch.kmers.index import (  # noqa: F401
    KmerIndex,
    build_index,
)
from uniprot_kmer_based_clustering_tpu_torch.kmers.bitset import (  # noqa: F401
    BitsetMatrix,
    DeviceBitsetMatrix,
    VirtualBitsetMatrix,
    pack_bitsets,
    pack_bitsets_device,
)
from uniprot_kmer_based_clustering_tpu_torch.kmers.append import (  # noqa: F401
    append_to_index,
)
