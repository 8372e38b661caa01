# Probe kernels: CUDA C++ for sm_90a under csrc/, each beside its plain
# torch version; wrappers launch the kernel on a CUDA tensor and run the
# plain version on a CPU tensor.
