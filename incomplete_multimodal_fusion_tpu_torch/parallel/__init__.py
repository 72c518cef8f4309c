"""Parallel training of the port (JAX package parallel/): process groups
(``dist``), meshes and a step's layout (``mesh``), collectives as autograd
functions (``comm``), tensor and sequence parallelism on local shards
(``sharding``), GPipe pipelining (``pipeline``, ``pp_multimae``) and the
moves of a training state between its one-device and sharded forms
(``state``)."""
from . import comm, dist, mesh

__all__ = ["comm", "dist", "mesh"]
