"""Multi-device particle sharding over a device mesh.

The reference is strictly single-GPU (one ``device`` global,
``nbody3d.js:2``; SURVEY §2.2); this package is the net-new first-class
scaling component: bodies are sharded along one mesh axis with
``jax.shard_map``, and the O(N^2) interaction set is covered either by a
ring exchange of source shards (``lax.ppermute`` — the
ring-attention communication schedule minus softmax, SURVEY §5.7) or by a
one-shot ``lax.all_gather`` for small N.
"""

from nbody3d_tpu.parallel.mesh import default_mesh, mesh_info  # noqa: F401
from nbody3d_tpu.parallel.sharded import (  # noqa: F401
    make_sharded_diagnostics,
    make_sharded_step,
    shard_state,
)
