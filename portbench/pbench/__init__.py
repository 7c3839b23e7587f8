"""The benchmark harness of the PyTorch port: cells found by name, weights
and traffic made from the seed, the measured window, the traced window's
readers, and the comparison with the plain reference."""
