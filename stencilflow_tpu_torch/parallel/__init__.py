"""Multi-device parallelism: domain decomposition over a device mesh."""
from .domain import (DomainDecomposition, compile_sharded_chain,
                     run_sharded_chain)
from .mesh import Mesh, ShardedArray

__all__ = ["DomainDecomposition", "compile_sharded_chain",
           "run_sharded_chain", "Mesh", "ShardedArray"]
