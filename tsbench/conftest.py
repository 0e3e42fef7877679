def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "cuda: needs an NVIDIA CUDA card; the test checks for one itself and "
        "skips without it")
