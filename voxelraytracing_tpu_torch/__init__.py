"""voxelraytracing_tpu_torch — the PyTorch and CUDA port of voxelraytracing_tpu.

A sparse-voxel ray-tracing engine for one or more NVIDIA H100 cards: an
infinite world of 32³-voxel chunks stored as flat, pointer-free
sparse-voxel-octree node arrays and as bit-plane tables, rendered by
per-pixel DDA traversal in hand-written CUDA kernels (``csrc/``, built
with nvcc at first use) — no triangle meshes — with data-driven world
generation on the device, a client/server streaming layer, and rendering
banded over several devices. Entry points run on the card unless the
caller asks for the CPU, where each kernel wrapper runs its plain PyTorch
version.

Layout:
  core/        node format, octree functional spec, coordinates, host
               geometry, the native host library (native/svo_core.cpp)
  csrc/        the hand-written CUDA kernels (march, planes, shade, path
               tracing, material fetch, the v3/v2 marches, probes)
  ops/         device compute: noise, SVO build, traversal, tracers, sky,
               camera, the v2/v3/v4 frames and path tracers
  models/      renderer families (user-facing)
  world/       node pool, world slices, streaming RenderGrid3 builder
  worldgen/    data-driven procedural chunk generation on the device
  resources/   RON/JSON datapacks, stylepacks, the standard resource pack
  net/, client/, server/   protocol, client game state, dedicated server
  engine/      the interactive frame loop (headless app shell, input, UI)
  parallel/    rendering banded and sampled over a mesh of devices
  tools/       installer, server CLI, terminal client, web viewer
  utils/       logging, profiling and tracing
  experiments/ the primitive probes
  graft_entry  the forward step and the multi-device dry run
"""

__version__ = "0.1.0"
