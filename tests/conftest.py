def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: launches a CUDA kernel; needs an NVIDIA GPU and "
        "nvcc, and skips without them")
