"""Models of the port: the paper's MLP, and the decoder stack of the
recurrent model zoo (rwkv6, recurrentgemma) for serving."""
