"""Device ops of the port: plain PyTorch, and wrappers of the CUDA kernels
(fill sweep, D8 stencil, accumulation sweep, distance sweep, terrain
stencil) with their plain versions."""
