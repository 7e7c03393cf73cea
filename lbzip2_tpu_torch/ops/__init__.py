"""Device ops of the port: PyTorch on tensors, plus hand-written CUDA."""
