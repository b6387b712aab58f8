"""Parallelism over ``torch.distributed``: the runtime, the mesh and its
row rules, the partition rules, and the collective primitives.

Counterpart of ``dotaclient_tpu/parallel/``. One process a card (SPMD):
data parallelism is the mesh's batch group (the learner's gradient and
loss sums, the lane-sharded actor, the sharded ring); ``sharding`` holds
the tensor-parallel rules; ``pipeline`` the GPipe schedule; ``sequence``
ring and Ulysses attention; ``expert`` the Switch routing and the explicit
expert dispatch.
"""

from dotaclient_tpu_torch.parallel.distributed import initialize_runtime, process_info
from dotaclient_tpu_torch.parallel.expert import make_expert_dispatch
from dotaclient_tpu_torch.parallel.mesh import (
    batch_axes,
    batch_shard_count,
    collective_probe_ms,
    data_sharding,
    make_mesh,
    replicated,
    row_sharding,
)
from dotaclient_tpu_torch.parallel.pipeline import make_pipeline, stack_stage_params
from dotaclient_tpu_torch.parallel.sequence import make_ring_attention, make_ulysses_attention
from dotaclient_tpu_torch.parallel.sharding import param_spec, state_shardings

__all__ = [
    "batch_axes",
    "batch_shard_count",
    "collective_probe_ms",
    "data_sharding",
    "initialize_runtime",
    "make_expert_dispatch",
    "process_info",
    "make_mesh",
    "make_pipeline",
    "make_ring_attention",
    "make_ulysses_attention",
    "param_spec",
    "replicated",
    "row_sharding",
    "stack_stage_params",
    "state_shardings",
]
