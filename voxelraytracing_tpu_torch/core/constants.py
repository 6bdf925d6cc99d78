"""World-format constants (the subset of voxelraytracing_tpu/core/constants.py
that the port uses; the values mirror the reference engine's chunk geometry,
common/src/world/mod.rs:9-25)."""

# Voxel width of a chunk (reference: common/src/world/mod.rs:10).
CHUNK_SIZE = 32

# Depth in a chunk's SVO at which nodes are voxel-sized: 2**CHUNK_DEPTH == CHUNK_SIZE
# (reference: common/src/world/mod.rs:14).
CHUNK_DEPTH = 5

# Maximum number of nodes a chunk can need: 1 + 8 + 64 + 512 + 4096 + 32768
# (reference: common/src/world/mod.rs:18).
NODES_PER_CHUNK = 37449

# Chunks per region-file edge (reference: common/src/world/mod.rs:25).
REGION_SIZE = 16

# Highest voxel id representable in a 15-bit node payload
# (reference: common/src/world/mod.rs:143).
VOXEL_MAX_VALUE = 0xFFFF // 2

# Ray-march iteration cap (reference: ray_tracer.wgsl:220).
MAX_RAY_STEPS = 500
