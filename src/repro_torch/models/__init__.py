"""The model zoo of the port: so far the decoder-only dense family."""
