"""pytest settings of the PyTorch/CUDA port (``nomad_tpu_torch``).

Registers the marker of tests that need an NVIDIA GPU. Such a test
decides inside itself whether a card is present and skips with a reason
where there is none, so every worker collects the same tests."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU with CUDA (skips elsewhere)"
    )
