"""Timing probes of single primitives on the card: the port's counterparts
of the JAX package's TPU probe scripts under ``experiments/`` (same file
names). Each module holds its kernels' wrappers, their plain PyTorch
versions and a ``main()`` that runs the probes on the card:

    python -m voxelraytracing_tpu_torch.experiments.v3_probe_prims
    python -m voxelraytracing_tpu_torch.experiments.v3_probe_subgather vec|loop
"""
