"""``repro_torch.api`` — the public surface of the PyTorch/CUDA port.

One config object, one session, explicit stages::

    from repro_torch.api import Heta, HetaConfig

    sess = Heta(HetaConfig())          # on the GPU (device="cpu" to opt out)
    sess.build_graph(); sess.partition(); sess.profile_and_cache()
    sess.compile()
    sess.fit()                         # train (run.steps steps)
    store = sess.infer_all()           # every node's embedding
    server = sess.serve()              # micro-batching lookups
    print(server.query([0, 1, 2]).scores)
    sess.close_serving()

:class:`HetaConfig` is field-for-field the reference package's
configuration tree (dict / flat-kwargs / CLI round-trips included).
"""

from repro_torch.api.config import (
    CacheConfig,
    CheckpointConfig,
    DataConfig,
    FaultConfig,
    HetaConfig,
    KernelConfig,
    ModelConfig,
    PartitionConfig,
    PipelineConfig,
    RunConfig,
    ScaleConfig,
    ServeConfig,
    add_config_args,
    config_from_args,
)
from repro_torch.api import executors
from repro_torch.api.session import CacheReport, Heta, HetaStageError, PartitionReport
from repro_torch.device import NoGPUError

__all__ = [
    "HetaConfig",
    "DataConfig",
    "PartitionConfig",
    "ModelConfig",
    "CacheConfig",
    "RunConfig",
    "PipelineConfig",
    "KernelConfig",
    "ServeConfig",
    "CheckpointConfig",
    "FaultConfig",
    "ScaleConfig",
    "Heta",
    "HetaStageError",
    "NoGPUError",
    "PartitionReport",
    "CacheReport",
    "executors",
    "add_config_args",
    "config_from_args",
]
