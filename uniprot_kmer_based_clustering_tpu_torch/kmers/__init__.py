"""k-mer encoding, the doc-freq index, the packed presence bitsets and
corpus appends (host numpy / C++), and the device index build (torch)."""
