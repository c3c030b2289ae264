def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU (the port's CUDA kernels); "
                   "skips without one")
