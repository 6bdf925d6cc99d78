"""World-format constants (the subset of voxelraytracing_tpu/core/constants.py
that the port uses; the values mirror the reference engine's chunk geometry,
common/src/world/mod.rs:9-25)."""

# Voxel width of a chunk (reference: common/src/world/mod.rs:10).
CHUNK_SIZE = 32

# Ray-march iteration cap (reference: ray_tracer.wgsl:220).
MAX_RAY_STEPS = 500
