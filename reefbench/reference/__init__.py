"""The plain reference the benchmark holds the port to.

`commitment` works the document commitment out again in plain Python
integers (`curve`, `poseidon`), `proof` ties each proof's claim about
the document to the document and its opening to the commitment,
`verdict` decides with Python's `re` whether the document matches, and
`artifact` reads the CLI's files.  Nothing here imports the port, the
JAX package or JAX, and nothing takes what the port made apart from the
artifacts it is judging.
"""
