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

# Extra headroom reserved when a chunk is placed into the shared node pool,
# so in-place edits rarely force a reallocation (reference: common/src/world/mod.rs:23).
CHUNK_INIT_FREE_MEM = 2048

# Chunks per region-file edge (reference: common/src/world/mod.rs:25).
REGION_SIZE = 16

# Highest voxel id representable in a 15-bit node payload
# (reference: common/src/world/mod.rs:143).
VOXEL_MAX_VALUE = 0xFFFF // 2

# Ray-march iteration caps (reference: ray_tracer.wgsl:220, path_tracer.wgsl:226).
MAX_RAY_STEPS = 500
MAX_PATH_STEPS = 200

# Epsilon used to nudge a ray across a node boundary
# (reference: ray_tracer.wgsl:188, :274).
RAY_EPS = 0.001
