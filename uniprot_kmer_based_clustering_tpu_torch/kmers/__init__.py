"""k-mer encoding, the doc-freq index and the packed presence bitsets
(host numpy / C++)."""
