"""voxelraytracing_tpu_torch: the PyTorch and CUDA port of voxelraytracing_tpu."""
