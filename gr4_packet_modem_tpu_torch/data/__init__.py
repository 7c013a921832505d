"""Protocol data files of the port: the header LDPC code (alist and
generator) and the golden RRC tap vectors, copies of the JAX package's
``data/`` files."""
