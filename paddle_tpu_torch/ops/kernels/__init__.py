"""Hand-written CUDA kernels of the port (sources in paddle_tpu_torch/csrc),
built with nvcc at first use (`_build`) and bound through ctypes."""
