"""Runnable examples of the PyTorch port (`python -m
repro_torch.examples.NAME`), the counterparts of the reference's
`examples/`."""
