"""pytest settings of the harness's own tests (portbench/)."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skips inside the test without")
