"""The model stack of the port: dense GQA and Mamba2 SSM decoder-only LMs
(``lm``), dispatched by family in ``api``.  Parameters are plain dicts of
tensors with the JAX package's tree; ``convert`` carries a JAX tree across
as numpy arrays."""
