"""Plain PyTorch references of the benchmark's models: one module per
``model.name`` of a configuration, found by that name. They import nothing
of the program and compute from the inputs the benchmark hands them."""
