"""Host I/O: the port's own copies of dashing_tpu/io/{paths,cache,fasta,
native,distmat}.py.  The files they read and write stay byte-compatible
with the JAX package's."""
