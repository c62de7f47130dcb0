"""The JAX package's graph core (``gnn_tpu.native``), loaded, for the tests
that hold the port's C++ graph core to it.

``gnn_tpu.native`` compiles its library in place (``g++ -o``) at its first
use in a checkout and, where the library does not load, keeps numpy
fallbacks for the rest of the process. In a fresh checkout the pytest-xdist
workers all build it at once, and a worker that loads a file that another
worker is still writing keeps the fallbacks: numpy's neighbour draws, which
differ from the C++ ones. The fixture builds the library once more, into a
directory of the worker's own, where that happened."""

import os

import pytest


@pytest.fixture(scope="session")
def jax_graph_core(tmp_path_factory):
    from gnn_tpu import native

    if not native.available():
        native._SO = str(tmp_path_factory.mktemp("jax_graph_core") / os.path.basename(native._SO))
        native._tried = False
        if not native.available():
            raise RuntimeError("the JAX package's graph core does not build here; its parity tests need it")
    return native
