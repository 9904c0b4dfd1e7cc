"""Sharded fits of vilma_tpu_torch: the shard-local genome layout
(alignment), the mesh of shards and its reductions (mesh) and the
multi-process launch and loading (distributed)."""
