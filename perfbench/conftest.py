"""The benchmark's tests: the ``gpu`` marker (a fixture in the test decides
whether there is a card, and skips where there is none)."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "gpu: needs a CUDA card; a fixture in the test decides and skips "
        "when there is none")
