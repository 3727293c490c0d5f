"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version.  A wrapper takes the plain version only for tensors on the CPU;
for CUDA tensors it launches the kernel (built with nvcc at first use)
or raises.  Each wrapper counts its launches in ``<wrapper>.launches``."""
