"""Usage examples of the port, each a module with ``main(argv=None)``, run
on the card by default (the JAX package's ``examples/`` counterparts):
``kernels`` (prefill, packed and decode attention), ``serve`` (continuous
batching of gpt-oss-20b at full width) and ``train`` (the mesh training
step, one process per rank)."""
