"""Multi-device parallelism: domain decomposition over a device mesh, and
the operator-pipeline split across the positions of a mesh axis."""
from .domain import (DomainDecomposition, compile_sharded_chain,
                     run_sharded_chain)
from .mesh import Mesh, ShardedArray
from .pipeline import (PipelineSplit, compile_pipeline_split,
                       run_pipeline_split)

__all__ = ["DomainDecomposition", "compile_sharded_chain",
           "run_sharded_chain", "Mesh", "ShardedArray", "PipelineSplit",
           "compile_pipeline_split", "run_pipeline_split"]
