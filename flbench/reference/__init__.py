"""The plain reference the benchmark holds the program to: f32 PyTorch,
no kernels, nothing of the program imported."""
