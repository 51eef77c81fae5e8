"""Host FASTA ingest and the ctypes binding of the C++ host runtime."""
