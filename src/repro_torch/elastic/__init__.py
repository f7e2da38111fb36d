"""Elastic membership of the port (counterpart of ``repro.elastic``):
only ``ElasticConfig``, the half of a RunSpec that a JAX spec carries.
The membership registry and the elastic session are not ported yet, so
``RunSpec.validate`` refuses ``elastic.enabled`` and ``evict_after``."""
from .config import ElasticConfig


class ElasticError(RuntimeError):
    """A membership change the elastic runtime cannot recover from."""
