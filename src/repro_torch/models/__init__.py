"""The model zoo of the port: so far the decoder-only dense, ssm (mamba2)
and hybrid (hymba) families."""
